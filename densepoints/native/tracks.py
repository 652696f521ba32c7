"""Native union-find track assembly binding."""
from __future__ import annotations

import ctypes

import numpy as np

from densepoints.native import _load, available

__all__ = ["available", "union_matches", "roots"]


def union_matches(
    num_views: int, n_kp: int, pairs: np.ndarray, matches: np.ndarray
) -> np.ndarray:
    """Parent array (V*N,) after unioning all matches (smaller-root-wins)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    pairs = np.ascontiguousarray(pairs, np.int32)
    matches = np.ascontiguousarray(matches, np.int32)
    parent = np.empty(num_views * n_kp, np.int64)
    lib.dp_union_matches(
        np.int32(num_views),
        np.int32(n_kp),
        np.int32(len(pairs)),
        pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        matches.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return parent


def roots(parent: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None, "native library unavailable"
    parent = np.ascontiguousarray(parent, np.int64)
    out = np.empty_like(parent)
    lib.dp_compress_roots(
        np.int64(len(parent)),
        parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out
