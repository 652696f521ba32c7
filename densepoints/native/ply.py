"""Native binary PLY writer binding (fallback: densepoints.io.ply)."""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from densepoints.native import _load, available

__all__ = ["available", "write_ply_native"]


def write_ply_native(path, positions, normals=None, colors=None) -> bool:
    """Write a binary PLY via the C++ writer. Returns False if unavailable."""
    lib = _load()
    if lib is None:
        return False
    positions = np.ascontiguousarray(positions, np.float32)
    n = len(positions)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    nrm_ptr = None
    col_ptr = None
    if normals is not None:
        normals = np.ascontiguousarray(normals, np.float32)
        nrm_ptr = normals.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.uint8)
        col_ptr = colors.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = lib.dp_write_ply(
        str(path).encode(),
        np.int64(n),
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nrm_ptr,
        col_ptr,
    )
    return rc == 0
