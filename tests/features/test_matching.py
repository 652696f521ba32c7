"""Descriptor + matching tests on the textured-plane scene."""
import jax.numpy as jnp
import numpy as np

from densepoints.core import Cameras
from densepoints.features import (
    brief_pattern,
    compute_descriptors,
    detect_keypoints,
    direct_epipolar_pair,
    filter_matches_epipolar,
    hamming_distance_matrix,
    match_pair,
)
from densepoints.geometry import fundamental_from_projections
from tests.synthetic import TexturedPlaneScene


def test_hamming_matrix_basic():
    a = jnp.asarray([[1.0, 1, -1, -1], [1, -1, 1, -1]], jnp.float32)
    b = jnp.asarray([[1.0, 1, -1, -1], [-1, -1, 1, 1]], jnp.float32)
    H = np.asarray(hamming_distance_matrix(a, b))
    np.testing.assert_allclose(H, [[0, 4], [2, 2]])


def _plane_setup(rng, num_views=2):
    scene = TexturedPlaneScene(rng, num_views=num_views, width=200, height=160)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    images = jnp.asarray(scene.render_all())
    return scene, cams, images


def test_matching_recovers_plane_correspondences(rng):
    scene, cams, images = _plane_setup(rng)
    xy, resp, valid = detect_keypoints(images, max_keypoints=512, border=16)
    pattern = jnp.asarray(brief_pattern())
    desc = compute_descriptors(images, xy, pattern)
    midx, dist = match_pair(desc[0], desc[1], valid[0], valid[1])
    F = fundamental_from_projections(scene.P[0], scene.P[1]).astype(np.float32)
    midx = filter_matches_epipolar(jnp.asarray(F), xy[0], xy[1], midx, 1.5)
    got = np.asarray(midx)
    n = (got >= 0).sum()
    assert n >= 30, f"only {n} surviving matches"
    # Verify matches against ground truth: both keypoints back-project to
    # the same plane point.
    x1 = np.asarray(xy[0])
    x2 = np.asarray(xy[1])
    P0, P1 = scene.P[0], scene.P[1]

    def backproject(P, C, px):
        Minv = np.linalg.inv(P[:, :3])
        ray = Minv @ np.append(px, 1.0)
        t = -C[2] / ray[2]
        return C + t * ray

    errs = []
    for i in np.nonzero(got >= 0)[0][:50]:
        w1 = backproject(P0, scene.C[0], x1[i])
        w2 = backproject(P1, scene.C[1], x2[got[i]])
        errs.append(np.linalg.norm(w1 - w2))
    errs = np.array(errs)
    # Majority of matches within ~1.5 px worth of world distance (0.03).
    assert np.median(errs) < 0.05, np.median(errs)


def test_direct_epipolar_matching(rng):
    scene, cams, images = _plane_setup(rng)
    xy, resp, valid = detect_keypoints(images, max_keypoints=256, border=16)
    F = jnp.asarray(
        fundamental_from_projections(scene.P[0], scene.P[1]).astype(np.float32)
    )
    midx, dist = direct_epipolar_pair(F, xy[0], xy[1], valid[0], valid[1], 1.5)
    got = np.asarray(midx)
    assert (got >= 0).sum() >= 20
    assert np.all(np.asarray(dist)[got >= 0] <= 1.5)


def test_match_pair_absolute_self_match():
    # Each descriptor's exact copy is distance 0 < 30 -> identity matching,
    # mirroring the reference's FLANN path absolute cutoff (matcher.cpp:240).
    from densepoints.features import match_pair_absolute

    rng = np.random.default_rng(7)
    desc = jnp.asarray(
        np.where(rng.uniform(size=(64, 256)) > 0.5, 1.0, -1.0).astype(np.float32)
    )
    valid = jnp.ones((64,), bool)
    midx, dist = match_pair_absolute(desc, desc, valid, valid)
    np.testing.assert_array_equal(np.asarray(midx), np.arange(64))
    np.testing.assert_allclose(np.asarray(dist), 0.0)
    # Far descriptors (flip > 30 bits) must be rejected.
    flipped = -desc
    midx2, _ = match_pair_absolute(desc, flipped, valid, valid)
    assert np.all(np.asarray(midx2) == -1)
