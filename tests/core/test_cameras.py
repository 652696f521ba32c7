"""Parity tests for projection-matrix decomposition and projection.

Golden anchors from tests/core/test_projection_matrix_decomposition.cpp:10-36.
"""
import numpy as np

from densepoints.core import (
    Cameras,
    decompose_projection_matrix,
    is_inside,
    project_points,
)
from tests.synthetic import random_scene

P_GOLDEN = np.array(
    [
        [3.53553e2, 3.39645e2, 2.77744e2, -1.44946e6],
        [-1.03528e2, 2.33212e1, 4.59607e2, -6.32525e5],
        [7.07107e-1, -3.53553e-1, 6.12372e-1, -9.18559e2],
    ]
)


def test_decomposition_golden():
    K, E, C = decompose_projection_matrix(P_GOLDEN)
    assert abs(K[0, 0] - 468.2) < 0.1, "fx"
    assert abs(K[1, 1] - 427.2) < 0.1, "fy"
    assert abs(K[0, 2] - 300) < 0.1, "cx"
    assert abs(K[1, 2] - 200) < 0.1, "cy"
    assert abs(K[2, 2] - 1) < 1e-9
    np.testing.assert_allclose(C, [1000, 2000, 1500], atol=0.01)
    # K @ E must recover P up to the reference's elementwise 0.5 tolerance;
    # ours reconstructs to float64 roundoff after rescaling by P's row-3 norm.
    recovered = K @ E
    scale = np.linalg.norm(P_GOLDEN[2, :3])
    np.testing.assert_allclose(recovered * scale, P_GOLDEN, atol=0.5)


def test_decomposition_rotation_orthonormal():
    _, E, _ = decompose_projection_matrix(P_GOLDEN)
    R = E[:, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-9)


def test_random_scene_roundtrip(rng):
    Ps, pts = random_scene(rng, num_views=4, num_points=10)
    for P in Ps:
        K, E, C = decompose_projection_matrix(P)
        recovered = K @ E
        # P is K_ref @ [R|t] with K_ref[2,2]=1 and det(R)=+1, so the scale
        # normalization by K[2,2] reproduces P exactly.
        np.testing.assert_allclose(recovered, P, rtol=1e-8, atol=1e-6)


def test_project_points_batched(rng):
    Ps, pts = random_scene(rng, num_views=3, num_points=32)
    cams = Cameras.from_projection_matrices(Ps, widths=4000, heights=3000)
    # Host reference projection in f64.
    expected = np.zeros((3, 32, 2))
    for v in range(3):
        hom = Ps[v] @ np.concatenate([pts, np.ones((32, 1))], axis=1).T
        expected[v] = (hom[:2] / hom[2]).T
    # Decomposed-form projection is well conditioned in f32 (~1e-2 px here);
    # the raw-P f32 product would lose ~1px to 1e6-magnitude cancellation.
    got = np.asarray(cams.project(pts.astype(np.float32)))
    np.testing.assert_allclose(got, expected, atol=0.05)
    # Raw-P path still agrees to within its f32 conditioning limit.
    raw = np.asarray(project_points(cams.P[:, None], pts.astype(np.float32)[None]))
    np.testing.assert_allclose(raw, expected, atol=5.0)


def test_project_with_depth_positive_in_front(rng):
    Ps, pts = random_scene(rng, num_views=3, num_points=16)
    cams = Cameras.from_projection_matrices(Ps, widths=4000, heights=3000)
    _, depth = cams.project_with_depth(pts.astype(np.float32))
    assert depth.shape == (3, 16)


def test_is_inside_strict_bounds():
    xy = np.array([[0.0, 5.0], [1.0, 5.0], [639.0, 5.0], [640.0, 5.0], [5, 0], [5, 479]])
    got = np.asarray(is_inside(xy, 640, 480))
    np.testing.assert_array_equal(got, [False, True, True, False, False, True])


def test_camera_center_nullspace(rng):
    Ps, _ = random_scene(rng, num_views=5)
    cams = Cameras.from_projection_matrices(Ps, widths=4000, heights=3000)
    C = np.asarray(cams.C, dtype=np.float64)
    for v in range(5):
        resid = Ps[v] @ np.concatenate([C[v], [1.0]])
        assert np.linalg.norm(resid) < 1e-2
