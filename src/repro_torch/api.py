"""The FreshIndex facade of the port: build a flat index and answer exact
k-NN queries, on the card unless the caller asks for the CPU.

    from repro_torch.api import FreshIndex, IndexConfig

    index = FreshIndex.build(series)                  # (n, L), on "cuda"
    dist, ids = index.search(queries, k=10)           # exact k-NN

    index = FreshIndex.build(series, device="cpu")    # the plain versions
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.convert import flat_index_from_numpy
from repro_torch.core import isax
from repro_torch.core.index import FlatIndex, build_index
from repro_torch.core.search import run_search

_BOUNDS = ("prefix", "symbox", "paabox")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Every knob of the ported index in one frozen place.

    segments       PAA/iSAX word length w (series length must divide by it)
    bits           symbol cardinality 2^bits
    leaf_capacity  series per flat leaf
    bound          leaf lower bound: 'prefix' (paper MINDIST) | 'symbox'
                   | 'paabox' (tightest)
    znorm          z-normalize series and queries (the paper's setting)
    dtype          storage dtype of the series matrix; search math is f32
    round_leaves   leaves refined per query per refinement round (K)
    """
    segments: int = isax.SEGMENTS
    bits: int = isax.SAX_BITS
    leaf_capacity: int = 64
    bound: str = "prefix"
    znorm: bool = True
    dtype: str = "float32"
    round_leaves: int = 8

    def __post_init__(self):
        if self.bound not in _BOUNDS:
            raise ValueError(f"bound must be one of {_BOUNDS}, "
                             f"got {self.bound!r}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {tuple(_DTYPES)}, "
                             f"got {self.dtype!r}")
        if self.segments < 1 or self.bits < 1 or self.bits > 8:
            raise ValueError("need segments >= 1 and 1 <= bits <= 8")
        if self.leaf_capacity < 1:
            raise ValueError("leaf_capacity must be >= 1")
        if self.round_leaves < 1:
            raise ValueError("round_leaves must be >= 1")

    def validate_series_len(self, L: int) -> None:
        """Raise ValueError unless series length L divides into `segments`
        equal PAA frames."""
        if L % self.segments != 0:
            raise ValueError(
                f"series length {L} is not divisible by segments="
                f"{self.segments}; pick a divisor or pad the series")


def resolve_device(device=None) -> torch.device:
    """None means "cuda".  Raises RuntimeError when CUDA is asked for and
    there is none: the port never falls back to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return dev


class FreshIndex:
    """A built flat index and its config.  Construct via build() or
    from_arrays()."""

    def __init__(self, idx: FlatIndex, config: IndexConfig):
        self._idx = idx
        self.config = config
        self._n_series = int(idx.valid.sum())

    @classmethod
    def build(cls, data, config: Optional[IndexConfig] = None, *,
              device=None) -> "FreshIndex":
        """Bulk-build an index over `data`, an (n, L) float array or tensor.

        Args:
            data: (n, L) series, n >= 1; cast to float32 on `device`.
            config: IndexConfig (None = defaults).
            device: where the index lives and the kernels run; None means
                "cuda".
        Returns:
            A new FreshIndex.
        Raises:
            ValueError: data is not 2-D with n >= 1, or L fails
                `config.validate_series_len`.
            RuntimeError: CUDA asked for (or defaulted to) and missing.
        """
        cfg = config or IndexConfig()
        dev = resolve_device(device)
        x = torch.as_tensor(data, dtype=torch.float32, device=dev)
        if x.dim() != 2 or x.shape[0] == 0:
            raise ValueError(f"data must be (n, L) with n >= 1, got shape "
                             f"{tuple(x.shape)}")
        cfg.validate_series_len(x.shape[1])
        idx = build_index(x, segments=cfg.segments, bits=cfg.bits,
                          leaf_capacity=cfg.leaf_capacity, znorm=cfg.znorm,
                          bound=cfg.bound)
        if cfg.dtype != "float32":
            idx = idx._replace(series=idx.series.to(_DTYPES[cfg.dtype]))
        return cls(idx, cfg)

    @classmethod
    def from_arrays(cls, arrays: dict, config: IndexConfig,
                    device=None) -> "FreshIndex":
        """Wrap a `repro` index carried across as numpy arrays (one per
        FlatIndex field, see `repro_torch.convert`); device None means
        "cuda"."""
        return cls(flat_index_from_numpy(arrays, resolve_device(device)),
                   config)

    @property
    def index(self) -> FlatIndex:
        """The underlying FlatIndex (read-only use)."""
        return self._idx

    @property
    def series_len(self) -> int:
        """Length L of every indexed series (and of valid queries)."""
        return self._idx.series.shape[1]

    @property
    def n_series(self) -> int:
        """Number of indexed series: what k may not exceed."""
        return self._n_series

    def search(self, queries, k: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact k-NN of `queries`, an (L,) or (Q, L) float array or tensor.

        Returns:
            (dist, ids) on the index's device: (Q,) for k == 1, (Q, k)
            ascending by distance otherwise.  Distances are Euclidean,
            recomputed in direct form for the winners.
        Raises:
            ValueError: query length != series_len, k < 1 or k > n_series.
        """
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self._idx.series.device)
        if q.dim() == 1:
            q = q[None]
        if q.shape[-1] != self.series_len:
            raise ValueError(
                f"queries have length {q.shape[-1]}, index holds series of "
                f"length {self.series_len}")
        if not 1 <= k <= self.n_series:
            raise ValueError(f"k must be in [1, {self.n_series}], got {k}")
        return run_search(self._idx, q, k=k,
                          round_leaves=self.config.round_leaves,
                          znorm=self.config.znorm)
