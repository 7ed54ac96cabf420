"""Host-side instance-label helpers (a copy of
``pctrans_tpu/data/label_utils.py``)."""

from __future__ import annotations

import numpy as np


def relabel_consecutive(seg: np.ndarray) -> np.ndarray:
    """Map instance labels to consecutive ids 1..K, keeping 0 = background.
    A crop with no background keeps all of its instances."""
    seg = np.asarray(seg)
    ids = np.unique(seg)
    fg = ids[ids != 0]
    lut = np.zeros(int(ids.max()) + 1 if ids.size else 1, np.int64)
    lut[fg] = np.arange(1, len(fg) + 1)
    out = lut[seg]
    dtype = seg.dtype if np.issubdtype(seg.dtype, np.integer) else np.int32
    return out.astype(dtype)
