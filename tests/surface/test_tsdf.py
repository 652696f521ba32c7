"""Surface extraction tests: plane and sphere reconstructions."""
import numpy as np

from densepoints.config import SurfaceConfig
from densepoints.surface import extract_surface


def test_plane_surface(rng):
    # Oriented samples of the plane z=0.
    n = 4000
    xy = rng.uniform(-1, 1, (n, 2))
    pos = np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    verts, faces = extract_surface(
        pos, nrm, SurfaceConfig(voxel_resolution=64)
    )
    assert len(verts) > 100 and len(faces) > 100
    # Mesh vertices lie near the plane (interior; borders may curl).
    interior = (np.abs(verts[:, 0]) < 0.8) & (np.abs(verts[:, 1]) < 0.8)
    assert interior.sum() > 50
    assert np.percentile(np.abs(verts[interior, 2]), 90) < 0.1


def test_sphere_surface(rng):
    n = 8000
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos = dirs.astype(np.float32)  # unit sphere
    nrm = dirs.astype(np.float32)  # outward normals
    verts, faces = extract_surface(
        pos, nrm, SurfaceConfig(voxel_resolution=64)
    )
    assert len(verts) > 200
    radii = np.linalg.norm(verts, axis=1)
    assert abs(np.median(radii) - 1.0) < 0.08, np.median(radii)


def test_empty_cloud():
    verts, faces = extract_surface(
        np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    )
    assert len(verts) == 0 and len(faces) == 0


def test_faces_index_valid_vertices(rng):
    n = 2000
    xy = rng.uniform(-1, 1, (n, 2))
    pos = np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)
    nrm = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    verts, faces = extract_surface(pos, nrm, SurfaceConfig(voxel_resolution=48))
    assert faces.min() >= 0 and faces.max() < len(verts)
