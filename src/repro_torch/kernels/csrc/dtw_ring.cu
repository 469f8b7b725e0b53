// dtw_scan's ring route at 18, 20, 22 and 24 cells a lane (L > 1,024:
// kernels/dtw.py scan_ring_cells), entry point dtw_scan_ring: dtw.cu's
// scan_ring_kernel instances of those widths (C / 2 a width, 42 in all),
// built as a library of their own so that nvcc compiles them beside
// dtw.cu's (which holds the 16-cell ones and every other DTW kernel), not
// after them in one process.  See dtw.cu for the kernels.
#define DTW_SCAN_WIDE_RINGS
#include "dtw.cu"
