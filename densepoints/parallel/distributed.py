"""Multi-device PMVS: sharded optimization + collective grid merging.

The reference has zero distribution (SURVEY.md §2.7/§5.8); this module is
the data-parallel design:

  * the patch set is sharded over the mesh's `patch` axis (NamedSharding on
    dim 0 of every PatchState leaf) — optimization, visibility and NCC
    filtering are embarrassingly patch-parallel, so pjit runs them without
    any communication;
  * occupancy-grid insertion needs global agreement; inside `shard_map`
    each device computes its local claim grid (scatter-min of GLOBAL
    candidate priorities) and a `jax.lax.pmin` over the patch axis merges
    claims — winners are then decided locally against the merged grid.
    The collective is one (V*Hg*Wg)-int min-reduction per round on ICI;
  * host-side orchestration (round loop, compaction) is unchanged from the
    single-device path.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from densepoints.config import OptimizeConfig, OrganizerConfig
from densepoints.core.cameras import Cameras
from densepoints.parallel.mesh import PATCH_AXIS, replicate, shard_patches
from densepoints.pmvs.optimize import (
    filter_by_error,
    filter_by_error_once,
    optimize_patches,
    optimize_patches_once,
)
from densepoints.pmvs.organizer import OccupancyGrids, candidate_cells
from densepoints.pmvs.patch import PatchState
from densepoints.pmvs.visibility import classify_views

__all__ = [
    "shard_state",
    "refine_step_impl",
    "refine_step_once",
    "distributed_refine_step",
    "distributed_insert",
    "pad_views",
    "viewsharded_insert",
]


def shard_state(state: PatchState, mesh) -> PatchState:
    """Place a PatchState with dim 0 sharded over the mesh patch axis.

    Capacity must be divisible by the mesh size (pad with dead patches).
    """
    sharding = shard_patches(mesh)
    n = mesh.devices.size
    pad = (-state.capacity) % n
    if pad:
        state = jax.tree.map(
            lambda a: jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
            ),
            state,
        )
    return jax.tree.map(lambda a: jax.device_put(a, sharding), state)


def refine_step_impl(
    images: jax.Array,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    optimize_config: OptimizeConfig = OptimizeConfig(),
) -> PatchState:
    """One sharded refine step: optimize -> reclassify -> NCC filter.

    Pure patch-parallel: with state sharded over the mesh, XLA partitions
    the whole computation with no collectives. Unjitted so callers can
    choose output shardings (the multi-host driver replicates outputs so
    host orchestration sees fully-addressable arrays).
    """
    state = optimize_patches(
        images, cameras, state, texture_size, optimize_config
    )
    vis, cand = classify_views(
        cameras,
        state.position,
        state.normal,
        state.ref,
        optimize_config.visible_angle,
        optimize_config.candidate_angle,
    )
    state = dataclasses.replace(state, vis=vis, cand=cand)
    return filter_by_error(
        images, cameras, state, texture_size, optimize_config
    )


distributed_refine_step = functools.partial(
    jax.jit, static_argnames=("texture_size", "optimize_config")
)(refine_step_impl)


def refine_step_once(
    images: jax.Array,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    optimize_config: OptimizeConfig = OptimizeConfig(),
) -> PatchState:
    """`refine_step_impl` without the `max_refine_batch` slicing wrappers.

    For drivers that slice the batch themselves OUTSIDE jit (the multihost
    round loop): jitting `refine_step_impl` would unroll `_sliced`'s loop
    into one XLA program, letting the scheduler keep every slice's buffers
    live and defeating the memory bound.
    """
    state = optimize_patches_once(
        images, cameras, state, texture_size, optimize_config
    )
    vis, cand = classify_views(
        cameras,
        state.position,
        state.normal,
        state.ref,
        optimize_config.visible_angle,
        optimize_config.candidate_angle,
    )
    state = dataclasses.replace(state, vis=vis, cand=cand)
    return filter_by_error_once(
        images, cameras, state, texture_size, optimize_config
    )


def distributed_insert(
    mesh,
    grids: OccupancyGrids,
    cameras: Cameras,
    state: PatchState,
    global_ids: jax.Array,
    organizer_config: OrganizerConfig = OrganizerConfig(),
):
    """Cross-device deduplicated grid insertion.

    state is sharded over PATCH_AXIS; grids/cameras replicated. Returns
    (accepted (P,) sharded bool, merged new grids replicated).
    """
    assert grids.slots_per_cell == 1, (
        "distributed insertion supports max_patches_per_cell=1"
    )
    V, Hg, Wg = grids.cells.shape
    n_cells = V * Hg * Wg
    scale = organizer_config.grid_scale
    min_grids = organizer_config.min_grids_to_accept

    cells = candidate_cells(grids, cameras, state.position, state.vis, scale)

    def local(flat_cells, alive, prio, occupied_flat):
        """Runs per device on its local patch shard."""
        active = alive[:, None] & (flat_cells >= 0)
        safe = jnp.where(active, flat_cells, n_cells)
        occ = jnp.concatenate([occupied_flat, jnp.ones((1,), bool)])[safe]
        active = active & ~occ
        safe = jnp.where(active, flat_cells, n_cells)
        big = jnp.iinfo(jnp.int32).max
        claim = jnp.full((n_cells + 1,), big, jnp.int32)
        claim = claim.at[safe.reshape(-1)].min(
            jnp.where(active, prio[:, None], big).reshape(-1)
        )
        # Merge claims across devices: global minimum priority per cell.
        claim = jax.lax.pmin(claim, PATCH_AXIS)
        won = active & (claim[safe] == prio[:, None])
        accepted = jnp.sum(won, axis=1) >= min_grids
        return accepted, won, claim

    # shard_map: cells/alive/prio sharded on dim 0; occupancy replicated.
    prio = global_ids.astype(jnp.int32)
    occupied = grids.cells.reshape(-1) >= 0

    accepted, won, _ = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(PATCH_AXIS), P(PATCH_AXIS), P(PATCH_AXIS), P()),
        out_specs=(P(PATCH_AXIS), P(PATCH_AXIS), P()),
    )(cells, state.alive, prio, occupied)

    # Final write on replicated data (host-visible, deterministic).
    write = won & accepted[:, None]
    flat = grids.cells.reshape(-1)
    safe = jnp.where(write, cells, n_cells).reshape(-1)
    vals = jnp.broadcast_to(prio[:, None], write.shape).reshape(-1)
    new_flat = jnp.concatenate([flat, jnp.zeros((1,), jnp.int32)])
    new_flat = new_flat.at[safe].set(vals)
    new_grids = dataclasses.replace(
        grids, cells=new_flat[:-1].reshape(V, Hg, Wg)
    )
    return accepted, new_grids


def pad_views(grids: OccupancyGrids, n: int) -> OccupancyGrids:
    """Pad the view dimension to a multiple of n (padded views stay empty:
    cols/rows = 0 makes every candidate cell out of bounds)."""
    V = grids.cells.shape[0]
    pad = (-V) % n
    if not pad:
        return grids
    return dataclasses.replace(
        grids,
        cells=jnp.concatenate(
            [grids.cells, jnp.full((pad,) + grids.cells.shape[1:], -1,
                                   grids.cells.dtype)]
        ),
        cols=jnp.concatenate([grids.cols, jnp.zeros((pad,), grids.cols.dtype)]),
        rows=jnp.concatenate([grids.rows, jnp.zeros((pad,), grids.rows.dtype)]),
    )


@functools.partial(jax.jit, static_argnames=("mesh", "min_grids"))
def viewsharded_insert(
    mesh,
    grids: OccupancyGrids,
    cell_ids: jax.Array,
    candidate_alive: jax.Array,
    global_ids: jax.Array,
    min_grids: int = 2,
):
    """Cross-device insertion with VIEW-sharded occupancy grids.

    The scalable merge protocol (SURVEY.md §5.8): each device owns a slice
    of views' occupancy grids — a cell has exactly ONE owner, so the
    scatter-min claim needs no merge at all. The only collective is the
    >=`min_grids` acceptance vote: a (P,)-int32 psum of per-device win
    counts, replacing the replicated-grid pmin of `distributed_insert`
    (V*Hg*Wg int32 per round — ~0.4 GB/round at DTU scale; this is ~4 B per
    candidate).

    cell_ids: (P, V) from `candidate_cells` with VIEW-major flat ids
      (view * Hg * Wg + row * Wg + col), -1 invalid. V must be a multiple of
      the mesh size (see `pad_views`).
    Returns (accepted (P,) bool replicated, new grids view-sharded).

    Multi-slot cells (`max_patches_per_cell` K > 1, patch_organizer.h:44):
    a cell is owned by exactly one device, so the K claim rounds of the
    single-device organizer (`bulk_try_insert`) run UNCHANGED on the local
    view slice; only the >=min_grids acceptance vote crosses devices.
    """
    V, Hg, Wg = grids.cells.shape[:3]
    K = grids.slots_per_cell
    n_dev = mesh.devices.size
    assert V % n_dev == 0, "pad_views() the grids to the mesh size first"
    v_loc = V // n_dev
    n_local = v_loc * Hg * Wg
    prio = global_ids.astype(jnp.int32)

    def local(cell_slice, alive, prio, grid_slice):
        """cell_slice (P, v_loc); grid_slice (v_loc, Hg, Wg[, K]) — local."""
        # Rebase global view-major ids to this device's slice.
        base = jax.lax.axis_index(PATCH_AXIS) * n_local
        local_ids = cell_slice - base
        slots = grid_slice.reshape(n_local, K)
        fill = jnp.sum(slots >= 0, axis=1)
        active = alive[:, None] & (cell_slice >= 0)
        safe = jnp.where(active, local_ids, n_local)
        big = jnp.iinfo(jnp.int32).max
        fill_ext = jnp.concatenate([fill, jnp.full((1,), K, fill.dtype)])
        won = jnp.zeros(active.shape, bool)
        # K claim rounds: each awards one free slot per cell to the lowest
        # remaining priority (K = 1 is the original single-pass scatter-min).
        for _ in range(K):
            a = active & ~won & (fill_ext[safe] < K)
            sc = jnp.where(a, local_ids, n_local)
            claim = jnp.full((n_local + 1,), big, jnp.int32)
            claim = claim.at[sc.reshape(-1)].min(
                jnp.where(a, prio[:, None], big).reshape(-1)
            )
            won_r = a & (claim[sc] == prio[:, None])
            won = won | won_r
            fill_ext = fill_ext.at[
                jnp.where(won_r, local_ids, n_local).reshape(-1)
            ].add(won_r.reshape(-1).astype(fill.dtype))
        # The ONLY collective: per-candidate win counts, summed over the
        # view shards.
        wins = jax.lax.psum(
            jnp.sum(won, axis=1).astype(jnp.int32), PATCH_AXIS
        )
        accepted = wins >= min_grids
        write = won & accepted[:, None]
        # Assign accepted winners to successive free slots (K-round rank,
        # same scheme as bulk_try_insert).
        slot_of = jnp.zeros(active.shape, jnp.int32)
        next_slot = jnp.concatenate([fill, jnp.zeros((1,), fill.dtype)])
        assigned = jnp.zeros(active.shape, bool)
        for _ in range(K):
            a = write & ~assigned
            sc = jnp.where(a, local_ids, n_local)
            claim = jnp.full((n_local + 1,), big, jnp.int32)
            claim = claim.at[sc.reshape(-1)].min(
                jnp.where(a, prio[:, None], big).reshape(-1)
            )
            pick = a & (claim[sc] == prio[:, None])
            slot_of = jnp.where(pick, next_slot[sc].astype(jnp.int32), slot_of)
            assigned = assigned | pick
            next_slot = next_slot.at[
                jnp.where(pick, local_ids, n_local).reshape(-1)
            ].add(pick.reshape(-1).astype(fill.dtype))
        wflat = jnp.where(
            write, local_ids * K + jnp.clip(slot_of, 0, K - 1), n_local * K
        ).reshape(-1)
        vals = jnp.broadcast_to(prio[:, None], write.shape).reshape(-1)
        new_flat = jnp.concatenate(
            [slots.reshape(-1), jnp.zeros((1,), jnp.int32)]
        )
        new_flat = new_flat.at[wflat].set(vals)
        return accepted, new_flat[:-1].reshape(grid_slice.shape)

    accepted, new_cells = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, PATCH_AXIS), P(), P(), P(PATCH_AXIS)),
        out_specs=(P(), P(PATCH_AXIS)),
    )(cell_ids, candidate_alive, prio, grids.cells)
    return accepted, dataclasses.replace(grids, cells=new_cells)
