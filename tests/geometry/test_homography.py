"""Homography DLT and analytic plane-homography tests."""
import numpy as np

from densepoints.geometry import (
    apply_homography,
    homography_from_4pts,
    plane_homography,
)
from tests.synthetic import random_scene


def test_4pt_dlt_exact(rng):
    src = rng.uniform(0, 100, (4, 2)).astype(np.float32)
    # A random projective map applied to src gives dst.
    H_true = np.array(
        [[1.2, 0.1, 5.0], [-0.05, 0.9, -3.0], [1e-3, -2e-3, 1.0]], np.float32
    )
    sh = np.concatenate([src, np.ones((4, 1), np.float32)], axis=1) @ H_true.T
    dst = (sh[:, :2] / sh[:, 2:]).astype(np.float32)
    H = np.asarray(homography_from_4pts(src, dst))
    got = np.asarray(apply_homography(H, src))
    np.testing.assert_allclose(got, dst, atol=1e-2)


def test_plane_homography_matches_projection(rng):
    Ps, _ = random_scene(rng, num_views=1)
    P = Ps[0].astype(np.float64)
    origin = np.array([0.5, -1.0, 2.0])
    ex = np.array([0.3, 0.1, 0.0])
    ey = np.array([-0.1, 0.25, 0.05])
    H = np.asarray(plane_homography(P, origin, ex, ey))
    for s, t in [(-1, -1), (1, -1), (0.3, 0.7), (0, 0)]:
        world = origin + s * ex + t * ey
        hom = P @ np.append(world, 1.0)
        expected = hom[:2] / hom[2]
        sh = H @ np.array([s, t, 1.0])
        got = sh[:2] / sh[2]
        np.testing.assert_allclose(got, expected, rtol=1e-6)
