"""Multi-scale pyramid tests."""
import jax.numpy as jnp
import numpy as np

from densepoints.core import Cameras
from densepoints.multiscale import build_pyramid, downsample2, scale_cameras
from tests.synthetic import TexturedPlaneScene


def test_downsample2_shapes_and_mean():
    img = jnp.asarray(np.arange(16, dtype=np.float32).reshape(1, 4, 4))
    out = np.asarray(downsample2(img))
    assert out.shape == (1, 2, 2)
    np.testing.assert_allclose(out[0, 0, 0], (0 + 1 + 4 + 5) / 4)


def test_scaled_cameras_project_consistently(rng):
    scene = TexturedPlaneScene(rng, num_views=2, width=200, height=160)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    half = scale_cameras(cams, 0.5)
    pts = jnp.asarray(rng.uniform(-0.5, 0.5, (10, 3)).astype(np.float32))
    full_pix = np.asarray(cams.project(pts))
    half_pix = np.asarray(half.project(pts))
    np.testing.assert_allclose(half_pix, full_pix * 0.5, atol=0.01)
    assert int(half.width[0]) == 100 and int(half.height[0]) == 80


def test_build_pyramid_levels(rng):
    scene = TexturedPlaneScene(rng, num_views=2, width=200, height=160)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    images = jnp.asarray(scene.render_all())
    pyr = build_pyramid(images, cams, 3)
    assert len(pyr) == 3
    assert pyr[1][0].shape == (2, 80, 100)
    assert pyr[2][0].shape == (2, 40, 50)
    assert int(pyr[2][1].width[0]) == 50
