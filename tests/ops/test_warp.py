"""Patch texture extraction tests on the textured-plane scene.

A fronto-parallel patch on the plane z=0, with its normal pointing along the
camera ray, must warp to near-identical textures in all views (up to bilinear
resampling error) — that is exactly the photometric-consistency assumption
PMVS optimizes. A patch with a wrong normal must score visibly worse.
"""
import jax.numpy as jnp
import numpy as np

from densepoints.core import Cameras, ncc_score
from densepoints.ops.warp import bilinear_sample, patch_textures
from tests.synthetic import TexturedPlaneScene


def _scene(rng, num_views=4):
    scene = TexturedPlaneScene(rng, num_views=num_views, width=200, height=160)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    images = jnp.asarray(scene.render_all())
    return scene, cams, images


def test_bilinear_sample_exact_on_grid(rng):
    img = jnp.asarray(rng.uniform(0, 255, (16, 16)).astype(np.float32))
    xy = jnp.asarray([[3.0, 5.0], [0.0, 0.0], [15.0, 15.0]])
    got = np.asarray(bilinear_sample(img, xy))
    expected = [float(img[5, 3]), float(img[0, 0]), float(img[15, 15])]
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_bilinear_sample_border_replicate(rng):
    img = jnp.asarray(rng.uniform(0, 255, (8, 8)).astype(np.float32))
    out = np.asarray(bilinear_sample(img, jnp.asarray([[-5.0, 3.0], [100.0, 3.0]])))
    np.testing.assert_allclose(out, [float(img[3, 0]), float(img[3, 7])], rtol=1e-6)


def test_true_plane_patch_high_ncc(rng):
    scene, cams, images = _scene(rng)
    # Patches at plane points, normal = plane normal (pointing away from
    # cameras at z<0 is (0,0,-1); reference convention: away from ref cam).
    pts = np.array([[0.0, 0.0, 0.0], [0.5, -0.3, 0.0], [-0.7, 0.4, 0.0]])
    B = len(pts)
    position = jnp.asarray(pts, jnp.float32)
    normal = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (B, 1))
    ref = jnp.zeros((B,), jnp.int32)
    mask = jnp.ones((B, cams.num_views), bool)
    tex, valid = patch_textures(images, cams, position, normal, ref, mask, 16)
    assert bool(jnp.all(valid)), "all views should see central plane patches"
    # NCC of view 0's texture against each other view should be high.
    flat = tex.reshape(B, cams.num_views, -1)
    # Correct geometry keeps NCC far above the 0.6 PMVS accept threshold in
    # every view (resampling blur costs a bit on the widest baselines).
    for v in range(1, cams.num_views):
        scores = np.asarray(ncc_score(flat[:, 0], flat[:, v]))
        assert np.all(scores > 0.8), (v, scores)


def test_wrong_normal_lowers_ncc(rng):
    scene, cams, images = _scene(rng)
    position = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    good_n = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    # A strongly tilted normal produces inconsistent warps across views.
    # Tilt about the camera x-axis: keeps |y| = |n x x_axis| = 1 so the
    # patch extent (and thus resampling blur) matches the good patch and
    # the comparison isolates geometric consistency.
    bad_n = jnp.asarray([[0.0, 0.9, -np.sqrt(1 - 0.81)]], jnp.float32)
    ref = jnp.zeros((1,), jnp.int32)
    mask = jnp.ones((1, cams.num_views), bool)
    tg, _ = patch_textures(images, cams, position, good_n, ref, mask, 16)
    tb, _ = patch_textures(images, cams, position, bad_n, ref, mask, 16)
    fg = tg.reshape(1, cams.num_views, -1)
    fb = tb.reshape(1, cams.num_views, -1)
    good = np.mean([float(ncc_score(fg[0, 0], fg[0, v])) for v in range(1, 4)])
    bad = np.mean([float(ncc_score(fb[0, 0], fb[0, v])) for v in range(1, 4)])
    assert good > bad + 0.02, (good, bad)


def test_out_of_view_patch_invalid(rng):
    scene, cams, images = _scene(rng)
    # A patch far outside the viewing frustum -> invalid everywhere.
    position = jnp.asarray([[50.0, 50.0, 0.0]], jnp.float32)
    normal = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    ref = jnp.zeros((1,), jnp.int32)
    mask = jnp.ones((1, cams.num_views), bool)
    _, valid = patch_textures(images, cams, position, normal, ref, mask, 16)
    assert not bool(jnp.any(valid))
