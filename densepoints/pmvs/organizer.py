"""Per-view occupancy grids as dense device arrays + bulk insertion.

Reference parity: `PatchGrid` / `PatchOrganizer` (patch_organizer.h/.cpp):
one grid per view at `grid_scale` px/cell, `max_patches_per_cell` = 1; a
patch is accepted iff it lands in >= 2 view grids (TryInsert,
patch_organizer.cpp:42-65). The reference stores raw pointers into cells
(with the dangling-pointer and end()-off-by-one bugs SURVEY.md §2.5 flags —
not replicated here).

Batched redesign: grids are ONE dense (V, Hg, Wg) int32 array of global patch
ids (-1 = empty). Insertion of a whole batch of candidates is a two-phase
scatter: (1) scatter-min of candidate priority into contested cells,
(2) gather-back to find winners; a candidate is accepted iff it wins >= 2
cells, and only accepted candidates are written. Priority = candidate index,
making contention resolution deterministic (the queue-order races of the
OpenMP reference become a fixed total order).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from densepoints.config import OrganizerConfig
from densepoints.core.cameras import Cameras

__all__ = [
    "OccupancyGrids",
    "make_grids",
    "candidate_cells",
    "bulk_try_insert",
    "prescreen_candidates",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OccupancyGrids:
    """cells: (V, Hg, Wg) int32 global patch ids, -1 empty — or
    (V, Hg, Wg, K) when `max_patches_per_cell` K > 1 (slots fill in
    ascending order, patch_organizer.h:40-47 semantics).

    cols/rows: (V,) int32 per-view valid grid extents (floor(W/scale),
    floor(H/scale) — the reference's integer division,
    patch_organizer.cpp:34-36).
    """

    cells: jax.Array
    cols: jax.Array
    rows: jax.Array

    @property
    def num_views(self) -> int:
        return self.cells.shape[0]

    @property
    def slots_per_cell(self) -> int:
        return 1 if self.cells.ndim == 3 else self.cells.shape[3]


def make_grids(
    cameras: Cameras, grid_scale: int, max_patches_per_cell: int = 1
) -> OccupancyGrids:
    cols = cameras.width // grid_scale
    rows = cameras.height // grid_scale
    Hg = int(jnp.max(rows))
    Wg = int(jnp.max(cols))
    shape = (cameras.num_views, Hg, Wg)
    if max_patches_per_cell > 1:
        shape = shape + (max_patches_per_cell,)
    cells = jnp.full(shape, -1, jnp.int32)
    return OccupancyGrids(cells=cells, cols=cols, rows=rows)


def candidate_cells(
    grids: OccupancyGrids,
    cameras: Cameras,
    position: jax.Array,
    vis: jax.Array,
    grid_scale: int,
):
    """Flat cell ids (B, V) for each patch in each view; -1 where invalid.

    A slot is valid where the view is in the patch's visible mask and the
    projected cell lies inside that view's grid bounds.
    """
    V, Hg, Wg = grids.cells.shape[:3]
    pix = cameras.project(position)  # (V, B, 2)
    col = jnp.floor(pix[..., 0] / grid_scale).astype(jnp.int32).T  # (B, V)
    row = jnp.floor(pix[..., 1] / grid_scale).astype(jnp.int32).T
    ok = (
        vis
        & (col >= 0)
        & (col < grids.cols[None, :])
        & (row >= 0)
        & (row < grids.rows[None, :])
    )
    view_ids = jnp.arange(V)[None, :]
    flat = view_ids * (Hg * Wg) + row * Wg + col
    return jnp.where(ok, flat, -1)


def _claim_rounds(cell_ids, active, prio, fill, K: int, n_cells: int):
    """K scatter-min claim rounds; returns won (B, V) bool.

    Each round awards one slot per cell to the lowest remaining priority
    among candidates whose cell still has free slots (K = 1 is the
    original single-pass scatter-min). Shared by `bulk_try_insert` (which
    then writes the winners) and `prescreen_candidates` (which only needs
    the would-win counts).
    """
    B = cell_ids.shape[0]
    safe_cells = jnp.where(active, cell_ids, n_cells)
    fill_ext = jnp.concatenate([fill, jnp.full((1,), K, fill.dtype)])
    won = jnp.zeros(cell_ids.shape, bool)
    for _ in range(K):
        a = active & ~won & (fill_ext[safe_cells] < K)
        sc = jnp.where(a, cell_ids, n_cells)
        claim = jnp.full((n_cells + 1,), B, jnp.int32)
        claim = claim.at[sc.reshape(-1)].min(
            jnp.where(a, prio, B).reshape(-1)
        )
        won_r = a & (claim[sc] == prio)
        won = won | won_r
        fill_ext = fill_ext.at[
            jnp.where(won_r, cell_ids, n_cells).reshape(-1)
        ].add(won_r.reshape(-1).astype(fill.dtype))
    return won


@functools.partial(jax.jit, static_argnames=("min_grids", "mode"))
def prescreen_candidates(
    grids: OccupancyGrids,
    cell_ids: jax.Array,
    candidate_alive: jax.Array,
    min_grids: int = 2,
    mode: str = "claim",
):
    """Which candidates COULD still be accepted at insertion time.

    The expansion pre-screen (VERDICT r4 #2): ~75-80% of optimized
    expansion candidates were discarded at insertion because their
    projected cells were already occupied — full Nelder-Mead runs thrown
    away. Both modes are NECESSARY conditions for `bulk_try_insert`
    acceptance evaluated on the PRE-optimization pose (optimization moves
    a candidate less than about one cell, so the screen is a slightly
    soft approximation; the A/B ladder artifact quantifies the effect):

      * "free":  >= min_grids of the candidate's valid cells have at
        least one free slot (ignores within-batch contention);
      * "claim": the candidate would win >= min_grids cells in the
        deterministic K-round claim against the rest of THIS batch —
        exactly the `bulk_try_insert` contest, minus the writes.

    Returns keep (B,) bool.
    """
    V, Hg, Wg = grids.cells.shape[:3]
    K = grids.slots_per_cell
    n_cells = V * Hg * Wg
    slots = grids.cells.reshape(n_cells, K) if K > 1 else (
        grids.cells.reshape(n_cells, 1)
    )
    fill = jnp.sum(slots >= 0, axis=1)
    active = candidate_alive[:, None] & (cell_ids >= 0)
    if mode == "free":
        safe = jnp.where(active, cell_ids, 0)
        has_free = active & (fill[safe] < K)
        return jnp.sum(has_free, axis=1) >= min_grids
    if mode != "claim":
        raise ValueError(f"unknown prescreen mode {mode!r}")
    B = cell_ids.shape[0]
    prio = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[:, None], cell_ids.shape
    )
    won = _claim_rounds(cell_ids, active, prio, fill, K, n_cells)
    return jnp.sum(won, axis=1) >= min_grids


@functools.partial(jax.jit, static_argnames=("min_grids",))
def bulk_try_insert(
    grids: OccupancyGrids,
    cell_ids: jax.Array,
    candidate_alive: jax.Array,
    global_ids: jax.Array,
    min_grids: int = 2,
):
    """Insert a batch of candidates with deterministic contention resolution.

    cell_ids: (B, V) from `candidate_cells` (-1 invalid).
    candidate_alive: (B,) candidates eligible for insertion.
    global_ids: (B,) the patch ids accepted candidates will occupy cells as.
    Returns (accepted (B,) bool, new_grids).

    With K = `grids.slots_per_cell` > 1 (OrganizerConfig
    max_patches_per_cell, patch_organizer.h:44), each cell admits up to K
    patches: the claim runs K rounds, each awarding one slot per cell to
    the lowest remaining priority.
    """
    V, Hg, Wg = grids.cells.shape[:3]
    K = grids.slots_per_cell
    B = cell_ids.shape[0]
    n_cells = V * Hg * Wg
    slots = grids.cells.reshape(n_cells, K) if K > 1 else (
        grids.cells.reshape(n_cells, 1)
    )
    fill = jnp.sum(slots >= 0, axis=1)  # (n_cells,) used slots

    active = candidate_alive[:, None] & (cell_ids >= 0)
    prio = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, V))

    won = _claim_rounds(cell_ids, active, prio, fill, K, n_cells)
    accepted = jnp.sum(won, axis=1) >= min_grids

    # Write accepted winners into successive free slots. Within a batch at
    # most K candidates won a given cell; their slot index is the prior
    # fill count plus their rank among the cell's winners (rank by
    # priority via a stable per-(cell) cumulative count).
    write = won & accepted[:, None]
    # Rank each write within its cell by priority order: process the K
    # rounds' winners in order again, assigning increasing slot ids.
    slot_of = jnp.zeros((B, V), jnp.int32)
    next_slot = jnp.concatenate([fill, jnp.zeros((1,), fill.dtype)])
    assigned = jnp.zeros((B, V), bool)
    for _ in range(K):
        a = write & ~assigned
        sc = jnp.where(a, cell_ids, n_cells)
        claim = jnp.full((n_cells + 1,), B, jnp.int32)
        claim = claim.at[sc.reshape(-1)].min(
            jnp.where(a, prio, B).reshape(-1)
        )
        pick = a & (claim[sc] == prio)
        slot_of = jnp.where(pick, next_slot[sc].astype(jnp.int32), slot_of)
        assigned = assigned | pick
        next_slot = next_slot.at[
            jnp.where(pick, cell_ids, n_cells).reshape(-1)
        ].add(pick.reshape(-1).astype(fill.dtype))

    wflat = jnp.where(
        write, cell_ids * K + jnp.clip(slot_of, 0, K - 1), n_cells * K
    ).reshape(-1)
    values = jnp.broadcast_to(
        global_ids.astype(jnp.int32)[:, None], (B, V)
    ).reshape(-1)
    new_slots = jnp.concatenate(
        [slots.reshape(-1), jnp.zeros((1,), jnp.int32)]
    )
    new_slots = new_slots.at[wflat].set(values)
    new_cells = new_slots[:-1].reshape(
        (V, Hg, Wg) if K == 1 else (V, Hg, Wg, K)
    )
    new_grids = dataclasses.replace(grids, cells=new_cells)
    return accepted, new_grids
