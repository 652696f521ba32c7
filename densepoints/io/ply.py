"""First-party PLY point-cloud / mesh writer (ascii + binary) and reader.

The reference uses the vendored rplycpp only for debug dumps
(`methods/pmvs/utils.cpp:9-50`) and its real exporter (`PMVS::GetPointCloud`)
is missing; here PLY is an output format of record. Binary little-endian is
the default (an order of magnitude faster to write and read for multi-million
point clouds). A native C++ writer (native/) is used automatically for large
binary clouds when built; this pure-python path is the always-available
fallback and the reference implementation for tests.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = ["write_ply", "read_ply", "write_mesh_ply"]


def _header(count: int, have_color: bool, have_normal: bool, binary: bool, face_count: int = 0):
    lines = ["ply"]
    lines.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    lines.append("comment densepoints")
    lines.append(f"element vertex {count}")
    lines += ["property float x", "property float y", "property float z"]
    if have_normal:
        lines += ["property float nx", "property float ny", "property float nz"]
    if have_color:
        lines += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    if face_count:
        lines.append(f"element face {face_count}")
        lines.append("property list uchar int vertex_indices")
    lines.append("end_header")
    return "\n".join(lines) + "\n"


def write_ply(
    path,
    positions: np.ndarray,
    normals: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Write a point cloud. positions (N,3) f32; normals (N,3); colors (N,3) u8."""
    positions = np.asarray(positions, np.float32)
    n = len(positions)
    have_n = normals is not None
    have_c = colors is not None
    if binary and n >= 10_000:
        # Large clouds: use the C++ writer when built (same byte format).
        try:
            from densepoints.native.ply import write_ply_native

            if write_ply_native(path, positions, normals, colors):
                return
        except Exception:
            pass
    header = _header(n, have_c, have_n, binary)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if binary:
        fields = [positions]
        dtypes = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if have_n:
            fields.append(np.asarray(normals, np.float32))
            dtypes += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        if have_c:
            fields.append(np.asarray(colors, np.uint8))
            dtypes += [("r", "u1"), ("g", "u1"), ("b", "u1")]
        rec = np.zeros(n, dtype=dtypes)
        rec["x"], rec["y"], rec["z"] = positions.T
        if have_n:
            nn = np.asarray(normals, np.float32)
            rec["nx"], rec["ny"], rec["nz"] = nn.T
        if have_c:
            cc = np.asarray(colors, np.uint8)
            rec["r"], rec["g"], rec["b"] = cc.T
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            rec.tofile(f)
    else:
        with open(path, "w") as f:
            f.write(header)
            for i in range(n):
                parts = [f"{v:.6f}" for v in positions[i]]
                if have_n:
                    parts += [f"{v:.6f}" for v in np.asarray(normals)[i]]
                if have_c:
                    parts += [str(int(v)) for v in np.asarray(colors)[i]]
                f.write(" ".join(parts) + "\n")


def write_mesh_ply(path, vertices: np.ndarray, faces: np.ndarray, binary: bool = True):
    """Write a triangle mesh (vertices (N,3) f32, faces (M,3) int32)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    header = _header(len(vertices), False, False, binary, face_count=len(faces))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if binary:
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            vertices.astype("<f4").tofile(f)
            rec = np.zeros(
                len(faces), dtype=[("n", "u1"), ("i", "<i4", (3,))]
            )
            rec["n"] = 3
            rec["i"] = faces
            rec.tofile(f)
    else:
        with open(path, "w") as f:
            f.write(header)
            for v in vertices:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def read_ply(path):
    """Minimal PLY reader for round-trip tests (vertex elements only).

    Returns dict with 'positions' and optionally 'normals', 'colors'.
    """
    with open(path, "rb") as f:
        # Parse header.
        fmt = None
        props = []
        count = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                count = int(line.split()[-1])
            elif line.startswith("element"):  # later elements ignored
                pass
            elif line.startswith("property") and count and "list" not in line:
                _, typ, name = line.split()
                props.append((name, typ))
            elif line == "end_header":
                break
        typemap = {"float": "<f4", "uchar": "u1", "double": "<f8"}
        if fmt == "binary_little_endian":
            dtype = [(n, typemap[t]) for n, t in props]
            rec = np.fromfile(f, dtype=dtype, count=count)
        else:
            rows = [f.readline().split() for _ in range(count)]
            arr = np.array(rows, dtype=np.float64)
            rec = {}
            for idx, (name, t) in enumerate(props):
                rec[name] = arr[:, idx]
    out = {"positions": np.stack([np.asarray(rec[k], np.float32) for k in "xyz"], 1)}
    names = [p[0] for p in props]
    if "nx" in names:
        out["normals"] = np.stack(
            [np.asarray(rec[k], np.float32) for k in ("nx", "ny", "nz")], 1
        )
    if "red" in names:
        out["colors"] = np.stack(
            [np.asarray(rec[k], np.uint8) for k in ("red", "green", "blue")], 1
        )
    return out
