"""Shape utilities for TPU-friendly padding.

TPU tiles are (sublane, 128)-shaped; keeping every device buffer padded to
lane/sublane multiples lets XLA tile matmuls onto the MXU without relayout.

The port's copy of ``neumann_tpu/utils/shapes.py``:
only its import lines differ.
"""

from __future__ import annotations

import numpy as np

LANE = 128  # last-dim tile width on TPU


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def pad_rows(arr: np.ndarray, target_rows: int, fill=0) -> np.ndarray:
    """Pad a 2-D array with ``fill`` rows up to ``target_rows``."""
    n = arr.shape[0]
    if n == target_rows:
        return arr
    if n > target_rows:
        raise ValueError(f"cannot pad {n} rows down to {target_rows}")
    pad = np.full((target_rows - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def pad_cols(arr: np.ndarray, target_cols: int, fill=0) -> np.ndarray:
    """Pad the last dim of an array with ``fill`` up to ``target_cols``."""
    d = arr.shape[-1]
    if d == target_cols:
        return arr
    if d > target_cols:
        raise ValueError(f"cannot pad {d} cols down to {target_cols}")
    widths = [(0, 0)] * (arr.ndim - 1) + [(0, target_cols - d)]
    return np.pad(arr, widths, constant_values=fill)
