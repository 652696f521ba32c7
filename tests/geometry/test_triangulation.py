"""DLT triangulation round-trip tests.

Parity anchors: tests/core/test_triangulation.cpp:11-52 — 2-view and N-view
round-trips with tolerance 0.01 on the reference fixture's camera/point
distribution (but seeded here, unlike the reference).
"""
import numpy as np

from densepoints.geometry import triangulate, triangulate_pair
from tests.synthetic import random_scene


def _project(P, X):
    h = P @ np.append(X, 1.0)
    return h[:2] / h[2]


def test_two_view_roundtrip(rng):
    Ps, pts = random_scene(rng, num_views=2, num_points=12)
    x1 = np.stack([_project(Ps[0], X) for X in pts]).astype(np.float32)
    x2 = np.stack([_project(Ps[1], X) for X in pts]).astype(np.float32)
    got = np.asarray(
        triangulate_pair(
            Ps[0].astype(np.float32), x1, Ps[1].astype(np.float32), x2
        )
    )
    np.testing.assert_allclose(got, pts, atol=0.01)


def test_multiview_roundtrip(rng):
    Ps, pts = random_scene(rng, num_views=5, num_points=12)
    obs = np.stack(
        [[_project(P, X) for P in Ps] for X in pts]
    ).astype(np.float32)  # (B, V, 2)
    got = np.asarray(triangulate(Ps.astype(np.float32), obs))
    np.testing.assert_allclose(got, pts, atol=0.01)


def test_masked_matches_subset(rng):
    Ps, pts = random_scene(rng, num_views=4, num_points=8)
    obs = np.stack(
        [[_project(P, X) for P in Ps] for X in pts]
    ).astype(np.float32)
    # Corrupt the last 2 views' observations, mask them off.
    obs_bad = obs.copy()
    obs_bad[:, 2:] += 500.0
    mask = np.zeros((8, 4), bool)
    mask[:, :2] = True
    got = np.asarray(
        triangulate(Ps.astype(np.float32), obs_bad, np.asarray(mask))
    )
    np.testing.assert_allclose(got, pts, atol=0.02)
