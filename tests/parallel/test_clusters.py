"""Covisibility view clustering (pod-scale image partitioning axis)."""
import numpy as np

from densepoints.core import Cameras
from densepoints.parallel.clusters import (
    cluster_halos,
    cluster_views,
    covisibility_matrix,
)
from tests.synthetic import TexturedPlaneScene


def _ring_cameras(n=12, radius=5.0, f=200.0, W=320, H=240):
    Ps = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        C = np.array([radius * np.sin(ang), 0.0, -radius * np.cos(ang)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
        Ps.append(K @ np.concatenate([R, (-R @ C)[:, None]], 1))
    return Cameras.from_projection_matrices(np.stack(Ps), widths=W, heights=H)


def test_covisibility_favors_neighbors():
    cams = _ring_cameras()
    aff = covisibility_matrix(cams)
    # Adjacent ring cameras are more covisible than opposite ones.
    assert aff[0, 1] > aff[0, 6]
    assert np.allclose(aff, aff.T)
    assert np.all(np.diag(aff) == 1.0)


def test_cluster_views_balanced_and_contiguous():
    cams = _ring_cameras(n=12)
    assign = cluster_views(cams, 4)
    sizes = np.bincount(assign, minlength=4)
    assert sizes.max() - sizes.min() <= 1
    # Ring neighbors should mostly share a cluster: count boundary cuts.
    cuts = sum(assign[i] != assign[(i + 1) % 12] for i in range(12))
    assert cuts <= 2 * 4, f"clusters fragmented: {assign}"


def test_cluster_halos_cover_members_and_neighbors():
    cams = _ring_cameras(n=12)
    assign = cluster_views(cams, 3)
    halos = cluster_halos(cams, assign, threshold=0.25)
    for c, views in enumerate(halos):
        members = np.nonzero(assign == c)[0]
        assert set(members).issubset(set(views.tolist()))
    # Halos overlap (boundary views held by two owners) but are far from
    # full replication for a threshold that prunes opposite views.
    total = sum(len(v) for v in halos)
    assert total > 12  # some halo overlap exists
    assert total < 3 * 12  # not full replication


def test_cluster_views_deterministic(rng):
    sc = TexturedPlaneScene(rng, num_views=7, width=64, height=48)
    cams = Cameras.from_projection_matrices(
        sc.P, widths=sc.width, heights=sc.height
    )
    a = cluster_views(cams, 3)
    b = cluster_views(cams, 3)
    np.testing.assert_array_equal(a, b)
