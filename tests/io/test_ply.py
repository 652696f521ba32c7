"""PLY writer/reader round-trip tests."""
import numpy as np

from densepoints.io import read_ply, write_mesh_ply, write_ply


def test_binary_roundtrip(tmp_path, rng):
    pos = rng.standard_normal((100, 3)).astype(np.float32)
    nrm = rng.standard_normal((100, 3)).astype(np.float32)
    col = rng.integers(0, 256, (100, 3)).astype(np.uint8)
    path = tmp_path / "cloud.ply"
    write_ply(path, pos, nrm, col, binary=True)
    out = read_ply(path)
    np.testing.assert_allclose(out["positions"], pos)
    np.testing.assert_allclose(out["normals"], nrm)
    np.testing.assert_array_equal(out["colors"], col)


def test_ascii_roundtrip(tmp_path, rng):
    pos = rng.standard_normal((10, 3)).astype(np.float32)
    path = tmp_path / "cloud_ascii.ply"
    write_ply(path, pos, binary=False)
    out = read_ply(path)
    np.testing.assert_allclose(out["positions"], pos, atol=1e-5)


def test_mesh_write(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    path = tmp_path / "mesh.ply"
    write_mesh_ply(path, verts, faces)
    data = path.read_bytes()
    assert b"element face 1" in data
