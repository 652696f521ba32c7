"""Occupancy grid bulk-insertion tests."""
import jax.numpy as jnp
import numpy as np

from densepoints.core import Cameras
from densepoints.pmvs.organizer import (
    bulk_try_insert,
    candidate_cells,
    make_grids,
)
from tests.synthetic import TexturedPlaneScene


def _setup(rng, num_views=4):
    scene = TexturedPlaneScene(rng, num_views=num_views, width=160, height=120)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    return scene, cams


def test_grid_dims_floor_division(rng):
    _, cams = _setup(rng)
    grids = make_grids(cams, 8)
    assert grids.cells.shape == (4, 15, 20)
    assert int(grids.cols[0]) == 20 and int(grids.rows[0]) == 15


def test_insert_and_dedup(rng):
    _, cams = _setup(rng)
    grids = make_grids(cams, 8)
    # Two patches at the same world position -> identical cells; only the
    # lower-index one may win; second is rejected (cells full / lost race).
    pos = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], jnp.float32)
    vis = jnp.ones((2, 4), bool)
    cells = candidate_cells(grids, cams, pos, vis, 8)
    assert np.asarray(cells >= 0).all()
    accepted, grids = bulk_try_insert(
        grids, cells, jnp.ones((2,), bool), jnp.asarray([0, 1], jnp.int32)
    )
    acc = np.asarray(accepted)
    assert acc[0] and not acc[1]
    # The winning id is stored in the cells.
    stored = np.asarray(grids.cells.reshape(-1))[np.asarray(cells)[0]]
    assert (stored == 0).all()


def test_insert_respects_existing_occupancy(rng):
    _, cams = _setup(rng)
    grids = make_grids(cams, 8)
    pos = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    vis = jnp.ones((1, 4), bool)
    cells = candidate_cells(grids, cams, pos, vis, 8)
    accepted, grids = bulk_try_insert(
        grids, cells, jnp.ones((1,), bool), jnp.asarray([7], jnp.int32)
    )
    assert np.asarray(accepted)[0]
    #

    accepted2, _ = bulk_try_insert(
        grids, cells, jnp.ones((1,), bool), jnp.asarray([8], jnp.int32)
    )
    assert not np.asarray(accepted2)[0], "occupied cells must reject"


def test_min_grids_rule(rng):
    _, cams = _setup(rng)
    grids = make_grids(cams, 8)
    pos = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    # Visible in only one view -> lands in 1 grid < 2 -> rejected.
    vis = jnp.zeros((1, 4), bool).at[0, 1].set(True)
    cells = candidate_cells(grids, cams, pos, vis, 8)
    accepted, new_grids = bulk_try_insert(
        grids, cells, jnp.ones((1,), bool), jnp.asarray([0], jnp.int32)
    )
    assert not np.asarray(accepted)[0]
    # Rejected patches leave no trace in the grids.
    assert (np.asarray(new_grids.cells) == -1).all()


def test_out_of_bounds_cells_invalid(rng):
    _, cams = _setup(rng)
    grids = make_grids(cams, 8)
    pos = jnp.asarray([[100.0, 0.0, 0.0]], jnp.float32)
    vis = jnp.ones((1, 4), bool)
    cells = candidate_cells(grids, cams, pos, vis, 8)
    assert (np.asarray(cells) == -1).all()


def test_multi_slot_cells_honored(rng):
    """max_patches_per_cell K > 1 (patch_organizer.h:44): a cell admits K
    patches, the K+1-th is rejected, slots fill in priority order."""
    import jax.numpy as jnp

    from densepoints.pmvs.organizer import bulk_try_insert, OccupancyGrids

    # One view grid, 2x2 cells, K=2 — three candidates all aim at cell 0
    # of views 0 and 1 (min_grids=2 so both must land).
    V, Hg, Wg, K = 2, 2, 2, 2
    grids = OccupancyGrids(
        cells=jnp.full((V, Hg, Wg, K), -1, jnp.int32),
        cols=jnp.full((V,), Wg, jnp.int32),
        rows=jnp.full((V,), Hg, jnp.int32),
    )
    # cell id layout: view * Hg * Wg + row * Wg + col
    cells = jnp.asarray(
        [[0, 4], [0, 4], [0, 4]], jnp.int32
    )  # all three want cell 0 in view 0 and cell 0 in view 1
    alive = jnp.ones((3,), bool)
    ids = jnp.asarray([10, 11, 12], jnp.int32)
    accepted, new = bulk_try_insert(grids, cells, alive, ids, min_grids=2)
    acc = np.asarray(accepted)
    assert acc.tolist() == [True, True, False]  # K=2 slots, third rejected
    c = np.asarray(new.cells)
    assert c[0, 0, 0].tolist() == [10, 11]
    assert c[1, 0, 0].tolist() == [10, 11]
    # Re-insert: cells are full now, everyone rejected.
    acc2, new2 = bulk_try_insert(new, cells, alive, ids + 5, min_grids=2)
    assert not np.any(np.asarray(acc2))
    np.testing.assert_array_equal(np.asarray(new2.cells), c)


def test_single_slot_path_unchanged(rng):
    """K = 1 keeps the original 3-D cells layout and semantics."""
    import jax.numpy as jnp

    from densepoints.pmvs.organizer import bulk_try_insert, OccupancyGrids

    grids = OccupancyGrids(
        cells=jnp.full((2, 2, 2), -1, jnp.int32),
        cols=jnp.full((2,), 2, jnp.int32),
        rows=jnp.full((2,), 2, jnp.int32),
    )
    cells = jnp.asarray([[0, 4], [0, 4]], jnp.int32)
    accepted, new = bulk_try_insert(
        grids, cells, jnp.ones((2,), bool), jnp.asarray([7, 8]), 2
    )
    assert np.asarray(accepted).tolist() == [True, False]
    assert new.cells.ndim == 3
    assert int(new.cells[0, 0, 0]) == 7 and int(new.cells[1, 0, 0]) == 7


def test_prescreen_matches_insert_acceptance():
    """`prescreen_candidates("claim")` must agree EXACTLY with
    `bulk_try_insert` acceptance when evaluated on the same cells — it is
    the same K-round claim contest minus the writes."""
    import jax.numpy as jnp

    from densepoints.pmvs.organizer import (
        OccupancyGrids,
        bulk_try_insert,
        prescreen_candidates,
    )

    rng2 = np.random.default_rng(3)
    grids = OccupancyGrids(
        cells=jnp.asarray(
            rng2.choice([-1, -1, -1, 5], size=(3, 4, 4)).astype(np.int32)
        ),
        cols=jnp.full((3,), 4, jnp.int32),
        rows=jnp.full((3,), 4, jnp.int32),
    )
    B = 40
    cells = jnp.asarray(
        np.where(
            rng2.uniform(size=(B, 3)) < 0.8,
            rng2.integers(0, 3 * 16, size=(B, 3)),
            -1,
        ).astype(np.int32)
    )
    alive = jnp.asarray(rng2.uniform(size=(B,)) < 0.9)
    keep = prescreen_candidates(grids, cells, alive, 2, "claim")
    accepted, _ = bulk_try_insert(
        grids, cells, alive, jnp.arange(B, dtype=jnp.int32), 2
    )
    np.testing.assert_array_equal(np.asarray(keep), np.asarray(accepted))
    # "free" is a necessary condition: it must keep everything claim keeps.
    free = np.asarray(prescreen_candidates(grids, cells, alive, 2, "free"))
    assert np.all(free[np.asarray(keep)])


def test_prescreen_full_cells_rejected():
    import jax.numpy as jnp

    from densepoints.pmvs.organizer import (
        OccupancyGrids,
        prescreen_candidates,
    )

    cells_arr = jnp.full((2, 2, 2), -1, jnp.int32).at[0, 0, 0].set(9)
    grids = OccupancyGrids(
        cells=cells_arr,
        cols=jnp.full((2,), 2, jnp.int32),
        rows=jnp.full((2,), 2, jnp.int32),
    )
    # candidate 0: cells (full, free) -> only 1 possible win -> screened
    # candidate 1: cells (free, free) -> kept
    cells = jnp.asarray([[0, 4], [1, 5]], jnp.int32)
    alive = jnp.ones((2,), bool)
    for mode in ("free", "claim"):
        keep = np.asarray(prescreen_candidates(grids, cells, alive, 2, mode))
        assert keep.tolist() == [False, True], mode
