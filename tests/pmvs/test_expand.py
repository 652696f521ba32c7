"""Wavefront expansion tests on the textured plane."""
import jax.numpy as jnp
import numpy as np

from densepoints.config import ExpandConfig, OptimizeConfig, OrganizerConfig
from densepoints.core import Cameras
from densepoints.pmvs import PatchState
from densepoints.pmvs.expand import expand_patches, make_expansion_candidates
from tests.synthetic import TexturedPlaneScene


def _setup(rng, num_views=5):
    scene = TexturedPlaneScene(rng, num_views=num_views, width=160, height=120)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    images = jnp.asarray(scene.render_all())
    return scene, cams, images


def _plane_seeds(cams, pts_xy):
    B = len(pts_xy)
    position = np.zeros((B, 3), np.float32)
    position[:, :2] = pts_xy
    normal = np.tile([0.0, 0.0, 1.0], (B, 1)).astype(np.float32)
    refs = np.zeros((B,), np.int32)
    vis = np.ones((B, cams.num_views), bool)
    vis[:, 0] = False
    return PatchState.create(position, normal, refs, vis)


def test_candidates_step_one_grid_cell(rng):
    scene, cams, images = _setup(rng)
    seeds = _plane_seeds(cams, [(0.0, 0.0)])
    cand = make_expansion_candidates(cams, seeds, grid_scale=8)
    assert cand.capacity == 4
    pix0 = np.asarray(cams.project(seeds.position))[0, 0]
    pix = np.asarray(cams.project(cand.position))[0]
    steps = np.linalg.norm(pix - pix0, axis=-1)
    # Steps project to ~grid_scale px in the reference view (the y steps
    # scale with |y_axis| which is 1 here).
    np.testing.assert_allclose(steps, 8.0, rtol=0.2)


def test_expansion_grows_and_stays_on_plane(rng):
    scene, cams, images = _setup(rng)
    seeds = _plane_seeds(cams, [(0.0, 0.0), (0.3, 0.2), (-0.4, -0.1)])
    cfg_e = ExpandConfig(max_rounds=3)
    cfg_o = OptimizeConfig(max_iterations=40)
    state, grids = expand_patches(
        images, cams, seeds, cfg_e, OrganizerConfig(), cfg_o
    )
    assert state.capacity > 3 * 3, f"expansion produced {state.capacity}"
    z = np.abs(np.asarray(state.position)[:, 2])
    assert np.median(z) < 0.05, np.median(z)
    # Occupancy grids must contain exactly the accepted patches' footprints.
    occ = (np.asarray(grids.cells) >= 0).sum()
    assert occ >= 2 * state.capacity
