"""Carry a `repro` (JAX) index across to the port.

`flat_index_from_numpy` takes the JAX FlatIndex as numpy arrays, one per
field (`{f: np.asarray(getattr(idx, f)) for f in idx._fields}`), and
returns the port's FlatIndex on a device.  This is what lets a test run
both packages' searches on the same index.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import FlatIndex


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")         # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry the
        # bit pattern as uint16 (as the JAX checkpoint store writes it)
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def flat_index_from_numpy(arrays: dict, device) -> FlatIndex:
    """{field: np.ndarray} for every FlatIndex field -> FlatIndex on
    `device`, each field keeping its dtype.  Raises KeyError naming any
    missing field."""
    missing = [f for f in FlatIndex._fields if f not in arrays]
    if missing:
        raise KeyError(f"missing FlatIndex fields: {missing}")
    return FlatIndex(**{f: _tensor(arrays[f], device)
                        for f in FlatIndex._fields})
