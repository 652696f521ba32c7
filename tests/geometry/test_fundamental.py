"""Fundamental matrix / epipolar geometry tests (property-based, seeded)."""
import numpy as np

from densepoints.geometry import (
    epipolar_distance_matrix,
    epipolar_lines,
    fundamental_from_projections,
    fundamental_matrices_for_pairs,
    point_line_distance,
)
from tests.synthetic import random_scene


def _project(P, X):
    h = P @ np.append(X, 1.0)
    return h[:2] / h[2]


def test_epipolar_constraint(rng):
    Ps, pts = random_scene(rng, num_views=2, num_points=20)
    F = fundamental_from_projections(Ps[0], Ps[1])
    for X in pts:
        x1 = np.append(_project(Ps[0], X), 1.0)
        x2 = np.append(_project(Ps[1], X), 1.0)
        # x2^T F x1 == 0 for corresponding points.
        val = abs(x2 @ F @ x1) / np.linalg.norm(F)
        assert val < 1e-4, val


def test_epipolar_distance_zero_for_correspondences(rng):
    Ps, pts = random_scene(rng, num_views=2, num_points=16)
    F = fundamental_matrices_for_pairs(Ps, np.array([[0, 1]]))[0]
    x1 = np.stack([_project(Ps[0], X) for X in pts]).astype(np.float32)
    x2 = np.stack([_project(Ps[1], X) for X in pts]).astype(np.float32)
    D = np.asarray(epipolar_distance_matrix(F.astype(np.float32), x1, x2))
    # Diagonal (true correspondences) should be ~0 px.
    assert np.abs(np.diag(D)).max() < 0.1


def test_point_line_distance_formula():
    lines = np.array([[3.0, 4.0, -25.0]], np.float32)  # 3x + 4y = 25
    pts = np.array([[3.0, 4.0]], np.float32)  # on line
    d = np.asarray(point_line_distance(lines, pts))
    np.testing.assert_allclose(d, [0.0], atol=1e-5)
    pts2 = np.array([[0.0, 0.0]], np.float32)
    d2 = np.asarray(point_line_distance(lines, pts2))
    np.testing.assert_allclose(d2, [5.0], rtol=1e-6)


def test_epipolar_lines_shape(rng):
    Ps, _ = random_scene(rng, num_views=2)
    F = fundamental_from_projections(Ps[0], Ps[1]).astype(np.float32)
    pts = rng.uniform(0, 100, (7, 2)).astype(np.float32)
    lines = np.asarray(epipolar_lines(F, pts))
    assert lines.shape == (7, 3)
