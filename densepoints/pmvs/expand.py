"""Patch expansion as bulk-synchronous wavefront rounds.

Reference parity: `Expand::ExpandPatches` / `ExpandPatch`
(expand.cpp:34-143): a shared work queue of patches; each pop generates 4
candidates stepped one occupancy-grid cell along +-x/+-y of the patch
tangent frame, simplex-optimizes each (texture 11), re-classifies
visibility, NCC-filters, and inserts survivors into the organizer (queueing
accepted ones). Termination: queue empty or 1e7 patches.

Batched redesign (SURVEY.md §7 "the hard redesign"): the sequential queue
becomes rounds over a frontier —

  round:  frontier (alive, >= 2 visible views, not yet expanded)
          -> 4 candidates each (tangent-plane steps of grid_scale/dx)
          -> batched simplex optimization (texture 11)
          -> batched visibility re-classification + NCC filter
          -> deterministic bulk grid insertion (scatter-priority dedup)
          -> accepted candidates are appended and form the next frontier

Queue-order races of the OpenMP version only ever affected which patch wins
a contested cell (max 1 patch/cell); here the winner is the lowest candidate
index — deterministic and seed-stable.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from densepoints.config import ExpandConfig, OptimizeConfig, OrganizerConfig
from densepoints.core.cameras import Cameras
from densepoints.ops.warp import patch_frames
from densepoints.pmvs.optimize import filter_by_error, optimize_patches
from densepoints.pmvs.organizer import (
    OccupancyGrids,
    bulk_try_insert,
    candidate_cells,
    make_grids,
    prescreen_candidates,
)
from densepoints.pmvs.patch import PatchState
from densepoints.pmvs.visibility import classify_views
from densepoints.utils import log

__all__ = ["make_expansion_candidates", "expand_patches"]


def make_expansion_candidates(
    cameras: Cameras, state: PatchState, grid_scale: int
) -> PatchState:
    """4 directional candidates per patch (expand.cpp:103-143).

    Steps are grid_scale/dx world units along +-x_axis, +-y_axis of the
    patch tangent frame — one occupancy cell in the reference image.
    Candidates inherit normal/ref/vis from the parent. Output capacity is
    4 * P, ordered [+x block, -x block, +y block, -y block].
    """
    # patch_frames scales by (k//2)/dx; with k = 2*grid_scale the scale is
    # exactly grid_scale/dx (expand.cpp:112).
    sx, sy = patch_frames(
        cameras, state.position, state.normal, state.ref, 2 * grid_scale
    )
    offsets = jnp.concatenate([sx, -sx, sy, -sy], axis=0)  # (4P, 3)
    tile = lambda a: jnp.concatenate([a, a, a, a], axis=0)
    return dataclasses.replace(
        state,
        position=tile(state.position) + offsets,
        normal=tile(state.normal),
        ref=tile(state.ref),
        vis=tile(state.vis),
        cand=tile(state.cand),
        alive=tile(state.alive),
        color=tile(state.color),
    )


def _pad_bucket(
    state: PatchState, minimum: int = 256, quantum: int = 0
) -> PatchState:
    """Pad capacity to a small set of bucket shapes.

    Small batches go to the next power of two (>= minimum); batches above
    quantum // 2 go to a MULTIPLE of `quantum` (= max_refine_batch), so
    every big dispatch the `_sliced` stages see is exactly quantum-shaped
    — ONE compiled program instead of one per power of two, since every
    fresh shape is a mid-run recompile. Dead padded lanes carry no
    visibility: the GPU scoring kernel schedules no slots for them, while
    the XLA scoring path still samples them (B * V work).
    """
    P = state.capacity
    if quantum:
        # Exactly TWO shapes ever: quantum//4 for small frontiers, k*quantum
        # (sliced to quantum-sized dispatches) for everything else.
        if P > quantum // 4:
            target = -(-P // quantum) * quantum
        else:
            target = quantum // 4
    else:
        target = minimum
        while target < P:
            target *= 2
    if target == P:
        return state
    pad = target - P
    return jax.tree.map(
        lambda a: jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
        ),
        state,
    )


def expand_patches(
    images: jax.Array,
    cameras: Cameras,
    seeds: PatchState,
    expand_config: ExpandConfig = ExpandConfig(),
    organizer_config: OrganizerConfig = OrganizerConfig(),
    optimize_config: OptimizeConfig = OptimizeConfig(),
):
    """Seed insertion + wavefront expansion.

    Returns (final PatchState with only accepted patches, grids).
    """
    grids = make_grids(
        cameras,
        organizer_config.grid_scale,
        organizer_config.max_patches_per_cell,
    )
    if expand_config.max_iterations > 0:
        # Candidates start one grid cell from a converged parent: a
        # reduced NM budget for expansion only (see ExpandConfig).
        optimize_config = dataclasses.replace(
            optimize_config, max_iterations=expand_config.max_iterations
        )

    # Insert seeds (PatchOrganizer::SetSeeds). Bucketed on accelerators:
    # the surviving-seed count varies run to run and each fresh shape
    # recompiles the (eager) cell projection.
    seeds = seeds.compact()
    if jax.default_backend() != "cpu":
        seeds = _pad_bucket(seeds)
    cells = candidate_cells(
        grids, cameras, seeds.position, seeds.vis, organizer_config.grid_scale
    )
    accepted, grids = bulk_try_insert(
        grids,
        cells,
        seeds.alive,
        jnp.arange(seeds.capacity, dtype=jnp.int32),
        organizer_config.min_grids_to_accept,
    )
    state = seeds.masked(accepted).compact()
    log.info("expansion: %d/%d seeds inserted", state.capacity, seeds.capacity)
    frontier = state
    # Accepted patches accumulate in per-round PARTS, concatenated ONCE at
    # the end: a per-round `state.concatenate` re-compiles the concat at a
    # fresh cumulative shape every round AND every run (accepted counts
    # vary run to run).
    parts = [state]
    total = state.capacity

    for round_idx in range(expand_config.max_rounds):
        if frontier.capacity == 0 or total >= expand_config.max_patches:
            break
        expandable = frontier.alive & (
            frontier.num_visible() >= expand_config.min_visible_views_to_expand
        )
        frontier = frontier.masked(expandable).compact()
        if frontier.capacity == 0:
            break

        # Shape quantization is an accelerator concern (the GPU scoring
        # kernel schedules no slots for dead padded lanes; on CPU the
        # padding would dominate test wall time).
        quantum = (
            optimize_config.max_refine_batch
            if jax.default_backend() != "cpu"
            else 0
        )
        if quantum:
            # Bucket the FRONTIER itself, not just the optimizer batch:
            # the raw compacted frontier has a fresh shape every round, so
            # candidate generation / cells / classification recompiled
            # per round, and compiling cost far more than the round's
            # compute. Frontier buckets of quantum//4 make every
            # downstream shape land in the same two-bucket family as the
            # NM stage.
            frontier = _pad_bucket(frontier, minimum=64, quantum=quantum // 4)
        cand = make_expansion_candidates(
            cameras, frontier, organizer_config.grid_scale
        )
        if expand_config.prescreen != "off":
            # Occupancy pre-screen: drop candidates that cannot reach
            # min_grids_to_accept cell wins BEFORE paying for Nelder-Mead
            # (most optimized candidates are discarded at insertion).
            # Padded to the SAME bucket shapes as the NM stage first: the
            # raw 4*frontier shape differs every round, and each fresh
            # shape would recompile the screen itself.
            cand = _pad_bucket(cand, quantum=quantum)
            pre_cells = candidate_cells(
                grids, cameras, cand.position, cand.vis,
                organizer_config.grid_scale,
            )
            keep = prescreen_candidates(
                grids, pre_cells, cand.alive,
                organizer_config.min_grids_to_accept,
                expand_config.prescreen,
            )
            n_before = int(jnp.sum(cand.alive))
            cand = cand.masked(keep & cand.alive).compact()
            log.info(
                "expansion round %d: prescreen %d -> %d candidates",
                round_idx, n_before, cand.capacity,
            )
            if cand.capacity == 0:
                break
        cand = _pad_bucket(cand, quantum=quantum)
        # Optimize candidates at the expansion texture size (11), then
        # re-classify visibility and NCC-filter (expand.cpp:128-137).
        cand = optimize_patches(
            images, cameras, cand, expand_config.texture_size, optimize_config
        )
        vis, cnd = classify_views(
            cameras,
            cand.position,
            cand.normal,
            cand.ref,
            optimize_config.visible_angle,
            optimize_config.candidate_angle,
        )
        cand = dataclasses.replace(cand, vis=vis, cand=cnd)
        cand = filter_by_error(
            images, cameras, cand, expand_config.texture_size, optimize_config
        )

        # Deduplicated insertion against current occupancy.
        cells = candidate_cells(
            grids, cameras, cand.position, cand.vis, organizer_config.grid_scale
        )
        accepted, grids = bulk_try_insert(
            grids,
            cells,
            cand.alive,
            total + jnp.arange(cand.capacity, dtype=jnp.int32),
            organizer_config.min_grids_to_accept,
        )
        new_patches = cand.masked(accepted).compact()
        log.info(
            "expansion round %d: frontier=%d candidates=%d accepted=%d total=%d",
            round_idx,
            frontier.capacity,
            cand.capacity,
            new_patches.capacity,
            total + new_patches.capacity,
        )
        if new_patches.capacity == 0:
            break
        parts.append(new_patches)
        total += new_patches.capacity
        frontier = new_patches

    state = parts[0] if len(parts) == 1 else jax.tree.map(
        lambda *ls: jnp.concatenate(ls, axis=0), *parts
    )
    return state, grids
