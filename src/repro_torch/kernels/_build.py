"""Build and load the CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` is compiled by hand with `nvcc` into its own shared
library with a plain C interface, and loaded with `ctypes`.  A library's
file name carries a hash of its source, of the `csrc/*.cuh` headers it
includes and of the compiler flags, so an edited source or header is
rebuilt at its next use and an unchanged one is loaded as it is.  The
first use of any kernel builds every missing library, one `nvcc` process
per source, all started together.  The tensor-core kernels take the
driver's TMA encoder at run time (`csrc/sm90.cuh`), so no library links
against libcuda and no include path beyond the toolkit's is needed.

The build directory is `build/` beside this file (listed in .gitignore).
Nothing here runs at import time: the CPU tests import this module on a
machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("isax_summarize", "lb_distance", "refine", "ed_argmin",
           "flash_attention", "leaf_stats", "dtw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
# serializes first builds: threads that launch kernels at once (the index
# builder's Refresh workers) would otherwise each run nvcc
_BUILD_LOCK = threading.Lock()
# guards the wrappers' launch counts, which those threads add to at once
COUNT_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under $CUDA_HOME (default
    /usr/local/cuda).  Raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built at first use and need the CUDA toolkit")


def headers(path: Path) -> List[Path]:
    """The headers under csrc/ that `path` includes (`#include "x.cuh"`),
    directly or through one another, in the order first met."""
    found: List[Path] = []
    todo = [path]
    while todo:
        here = todo.pop(0)
        for m in _INCLUDE.finditer(here.read_text()):
            h = here.parent / m.group(1)
            if h not in found:
                found.append(h)
                todo.append(h)
    return found


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` lives, keyed by the hash of
    everything it is compiled from: the source, the headers it includes
    and the flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in headers(src):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    """The nvcc command line that compiles `csrc/<name>.cu` into `out`."""
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all() -> Dict[str, dict]:
    """Compile every library that is missing, in parallel.  Each output
    is written under a name that carries the process and the thread, then
    renamed into place, so two builders never write one file.

    Returns {name: {"seconds": wall time or 0.0 if cached, "ptxas": the
    compiler's resource report}}.  Raises RuntimeError with the
    compiler's output if any source fails to compile.
    """
    report: Dict[str, dict] = {}
    missing = []
    for name in SOURCES:
        if library_path(name).is_file():
            report[name] = {"seconds": 0.0, "ptxas": ""}
        else:
            missing.append(name)
    if missing:
        nvcc_path()                    # raises before anything is written
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in missing:
        out = library_path(name)
        tmp = out.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{log}")
            continue
        os.replace(tmp, out)           # atomic: a reader never sees half
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


_LOADED: Dict[str, ctypes.PyDLL] = {}


def library(name: str) -> ctypes.PyDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed.

    Loaded as a `ctypes.PyDLL`, whose calls keep the interpreter lock: a
    launch takes microseconds, and the index builder's worker threads,
    which launch one kernel a part, spent far longer handing the lock to
    one another around each call than in it (PERF.md §5).

    Thread-safe: the first calls from several threads build and load it
    once, under a lock; later calls read the loaded library without one.
    """
    lib = _LOADED.get(name)
    if lib is None:
        with _BUILD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                path = library_path(name)
                if not path.is_file():
                    build_all()
                lib = _LOADED[name] = ctypes.PyDLL(str(path))
    return lib


_ENTRIES: Dict[tuple, object] = {}


def entry(source: str, name: str, argtypes: list):
    """The C entry point `name` of `csrc/<source>.cu`, returning an int,
    typed once and then taken from a cache (the index builder calls some
    once for each part).  Pointers and the stream go as ctypes.c_void_p,
    so none is cut to 32 bits."""
    fn = _ENTRIES.get((source, name))
    if fn is None:
        fn = getattr(library(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[(source, name)] = fn
    return fn


def check(source: str, name: str, code: int) -> None:
    """Raise RuntimeError if entry point `name` returned a CUDA error; each
    library exports `<name>_error` to spell it out."""
    if code != 0:
        fn = getattr(library(source), f"{name}_error")
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {code} at launch: "
                           f"{fn(code).decode()}")
