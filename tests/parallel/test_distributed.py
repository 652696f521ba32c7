"""Multi-device tests on the 8-way virtual CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np

from densepoints.config import OptimizeConfig, OrganizerConfig
from densepoints.core import Cameras
from densepoints.parallel import (
    distributed_insert,
    distributed_refine_step,
    make_mesh,
    shard_state,
)
from densepoints.pmvs import PatchState, filter_by_error, optimize_patches
from densepoints.pmvs.organizer import (
    bulk_try_insert,
    candidate_cells,
    make_grids,
)
from tests.synthetic import TexturedPlaneScene


def _setup(rng, num_views=5):
    scene = TexturedPlaneScene(rng, num_views=num_views, width=160, height=120)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    images = jnp.asarray(scene.render_all())
    return scene, cams, images


def _plane_patches(cams, n, rng):
    xy = rng.uniform(-0.8, 0.8, (n, 2))
    position = np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    refs = np.zeros((n,), np.int32)
    vis = np.ones((n, cams.num_views), bool)
    vis[:, 0] = False
    return PatchState.create(position, normal, refs, vis)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_refine_matches_single_device(rng):
    scene, cams, images = _setup(rng)
    state = _plane_patches(cams, 16, rng)
    cfg = OptimizeConfig(max_iterations=25)

    single = distributed_refine_step(images, cams, state, 16, cfg)

    mesh = make_mesh()
    sharded = shard_state(state, mesh)
    multi = distributed_refine_step(images, cams, sharded, 16, cfg)

    np.testing.assert_allclose(
        np.asarray(single.position),
        np.asarray(multi.position),
        atol=1e-4,
    )
    np.testing.assert_array_equal(
        np.asarray(single.alive), np.asarray(multi.alive)
    )


def test_distributed_insert_matches_single_device(rng):
    scene, cams, images = _setup(rng)
    state = _plane_patches(cams, 64, rng)
    grids = make_grids(cams, 8)
    ids = jnp.arange(64, dtype=jnp.int32)

    cells = candidate_cells(grids, cams, state.position, state.vis, 8)
    acc_single, grids_single = bulk_try_insert(
        grids, cells, state.alive, ids, 2
    )

    mesh = make_mesh()
    sharded = shard_state(state, mesh)
    acc_multi, grids_multi = distributed_insert(
        mesh, grids, cams, sharded, ids, OrganizerConfig()
    )
    np.testing.assert_array_equal(
        np.asarray(acc_single), np.asarray(acc_multi)
    )
    np.testing.assert_array_equal(
        np.asarray(grids_single.cells), np.asarray(grids_multi.cells)
    )


def test_viewsharded_insert_matches_single_device(rng):
    """The view-sharded merge protocol (one (P,) psum, no grid replication)
    must accept exactly the same candidates and build the same occupancy as
    the single-device organizer."""
    from densepoints.parallel.distributed import (
        pad_views,
        viewsharded_insert,
    )

    scene, cams, images = _setup(rng, num_views=5)
    state = _plane_patches(cams, 64, rng)
    mesh = make_mesh()
    n_dev = mesh.devices.size

    grids0 = make_grids(cams, 8)
    cells0 = candidate_cells(grids0, cams, state.position, state.vis, 8)
    ids = jnp.arange(state.capacity, dtype=jnp.int32)
    want_accept, want_grids = bulk_try_insert(
        grids0, cells0, state.alive, ids, 2
    )

    # View-sharded: pad V 5 -> 8 so each device owns one view's grid.
    gpad = pad_views(make_grids(cams, 8), n_dev)
    vis_pad = jnp.pad(
        state.vis, ((0, 0), (0, gpad.cells.shape[0] - cams.num_views))
    )
    V, Hg, Wg = grids0.cells.shape
    Vp = gpad.cells.shape[0]
    # Rebuild flat ids in the PADDED view-major layout from the unpadded
    # ones (same Hg/Wg, so only the view stride count changes — ids are
    # already view * Hg * Wg + offset, identical for views < V).
    cells_pad = jnp.pad(cells0, ((0, 0), (0, Vp - V)), constant_values=-1)
    got_accept, got_grids = viewsharded_insert(
        mesh, gpad, cells_pad, state.alive, ids, 2
    )
    np.testing.assert_array_equal(
        np.asarray(got_accept), np.asarray(want_accept)
    )
    np.testing.assert_array_equal(
        np.asarray(got_grids.cells)[:V], np.asarray(want_grids.cells)
    )
    # Padded views stayed empty.
    assert np.all(np.asarray(got_grids.cells)[V:] == -1)


def test_viewsharded_insert_respects_occupancy(rng):
    """Cells already occupied must reject newcomers (per-view owner check)."""
    from densepoints.parallel.distributed import (
        pad_views,
        viewsharded_insert,
    )

    scene, cams, images = _setup(rng, num_views=5)
    state = _plane_patches(cams, 16, rng)
    mesh = make_mesh()
    grids0 = make_grids(cams, 8)
    cells0 = candidate_cells(grids0, cams, state.position, state.vis, 8)
    V = grids0.cells.shape[0]
    Vp = pad_views(grids0, mesh.devices.size).cells.shape[0]
    cells_pad = jnp.pad(cells0, ((0, 0), (0, Vp - V)), constant_values=-1)
    gpad = pad_views(grids0, mesh.devices.size)
    ids = jnp.arange(16, dtype=jnp.int32)
    acc1, g1 = viewsharded_insert(mesh, gpad, cells_pad, state.alive, ids, 2)
    # Re-inserting the same candidates against the filled grids: everyone
    # who won cells before must now be rejected (cells occupied).
    acc2, g2 = viewsharded_insert(
        mesh, g1, cells_pad, state.alive, ids + 100, 2
    )
    assert not np.any(np.asarray(acc2) & np.asarray(acc1))
    np.testing.assert_array_equal(np.asarray(g1.cells), np.asarray(g2.cells))
