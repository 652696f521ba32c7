"""Visibility classification tests (Patch::InitRelatedImages semantics)."""
import jax.numpy as jnp
import numpy as np

from densepoints.core import Cameras
from densepoints.pmvs import classify_views, compute_color
from tests.synthetic import TexturedPlaneScene


def _cams(rng, num_views=5):
    scene = TexturedPlaneScene(rng, num_views=num_views, width=200, height=160)
    return scene, Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )


def test_plane_patch_visible_in_all_other_views(rng):
    scene, cams = _cams(rng)
    # Normal away from ref camera 0: cameras sit at z<0, so away is +z.
    pos = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    vis, cand = classify_views(cams, pos, n, jnp.asarray([0], jnp.int32))
    vis = np.asarray(vis)[0]
    assert not vis[0], "reference view must be excluded (patch.cpp:30)"
    assert vis[1:].all(), "ring cameras all within the 45-degree cone"


def test_reversed_normal_never_visible(rng):
    scene, cams = _cams(rng)
    pos = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)  # toward the cameras
    vis, cand = classify_views(cams, pos, n, jnp.asarray([0], jnp.int32))
    assert not np.asarray(vis).any()
    assert not np.asarray(cand).any()


def test_candidate_band(rng):
    scene, cams = _cams(rng)
    pos = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    # Tilt the normal so some views fall in the 0.78..1.04 band.
    tilt = 0.9
    n = jnp.asarray(
        [[np.sin(tilt), 0.0, np.cos(tilt)]], jnp.float32
    )
    vis, cand = classify_views(cams, pos, n, jnp.asarray([0], jnp.int32))
    vis, cand = np.asarray(vis)[0], np.asarray(cand)[0]
    assert not (vis & cand).any()
    assert cand.any(), "tilted normal should yield candidate views"


def test_out_of_image_point_not_visible(rng):
    scene, cams = _cams(rng)
    pos = jnp.asarray([[100.0, 0.0, 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    vis, cand = classify_views(cams, pos, n, jnp.asarray([1], jnp.int32))
    assert not np.asarray(vis).any()


def test_compute_color_averages_views(rng):
    scene, cams = _cams(rng, num_views=3)
    gray = scene.render_all()  # (V, H, W)
    colors = np.stack([gray, gray * 0.5, gray * 0.25], axis=-1)
    pos = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    rgb = np.asarray(compute_color(cams, jnp.asarray(colors), pos))[0]
    # Channel ratios preserved by averaging.
    assert abs(rgb[1] / rgb[0] - 0.5) < 0.01
    assert abs(rgb[2] / rgb[0] - 0.25) < 0.01
