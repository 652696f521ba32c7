"""Cluster-partitioned multi-host densification (pod-scale image ownership).

The SPMD driver (`parallel/multihost.py`) replicates the full image stack
to every process — the right call for DTU-scale stacks (376 MB f32, ~0.5%
of an 80 GB card), the
wrong one for BASELINE config-5 scenes (hundreds of full-res views; the
reference itself bothers with per-view image load/unload,
modules/core/types.cpp:7-25). This module is the partitioned driver the
clustering foundation (`parallel/clusters.py`) was built for:

  * views are clustered by covisibility (`cluster_views`), one cluster per
    PROCESS; each process holds ONLY its cluster's images plus the halo —
    views covisible with a member above `halo_threshold`
    (`cluster_halos`). Per-process image bytes drop to ~|halo_c| / V of
    the replicated stack.
  * PATCHES are sharded by the cluster of their reference view: a patch
    lives on the process that owns its reference image, and every view it
    can score against is in that process's halo by construction.
    Visibility is truncated to the halo (vis &= halo) — the documented
    semantics: the covisibility threshold bounds photometric support
    exactly like `MatchingConfig.max_pairs_per_view` bounds matching
    support.
  * all image-touching stages (NCC filter, Nelder-Mead refinement) run
    LOCALLY per process on the halo subset via the single-host jitted
    paths — zero cross-host pixel traffic, ever.
  * occupancy grids are REPLICATED (V*Hg*Wg int32 — a few MB even at
    hundreds of views) and insertion claims are resolved globally: each
    round the processes exchange their candidates' (cells, alive,
    priority) — small int32 tables, the only expansion collective — and
    every process runs the SAME deterministic `bulk_try_insert` contest on
    the canonical-priority-sorted global list. Canonical priorities
    (seed index; accepted-rank * 4 + direction for expansion candidates)
    make the contest independent of the process count.

Determinism contract (same as the cross-mesh-size contract): the contest and all acceptance logic are exactly
reproducible across process counts; patch POSITIONS wobble at ~1e-6
across process counts because per-process batch shapes differ and XLA
vectorizes the Nelder-Mead reductions per shape — N-process equals
1-process at (count, 5e-3) like the multiscale mesh tests assert.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from densepoints.config import PipelineConfig
from densepoints.core.cameras import Cameras
from densepoints.parallel.clusters import cluster_halos, cluster_views
from densepoints.pmvs.expand import make_expansion_candidates
from densepoints.pmvs.filter import run_filters
from densepoints.pmvs.optimize import filter_by_error, optimize_patches
from densepoints.pmvs.organizer import (
    bulk_try_insert,
    candidate_cells,
    make_grids,
)
from densepoints.pmvs.patch import PatchState
from densepoints.pmvs.pipeline import DensifyResult
from densepoints.pmvs.seed import (
    create_patches_from_points,
    generate_seed_points,
)
from densepoints.pmvs.visibility import classify_views, compute_color
from densepoints.utils import StageMetrics, log

__all__ = ["densify_clustered", "ClusterPlan", "plan_clusters"]


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The image-ownership layout for one process.

    assign: (V,) int32 cluster id per view.
    my_views: sorted global view ids this process HOLDS (members + halo).
    member_mask / halo_mask: (V,) bool.
    """

    assign: np.ndarray
    my_views: np.ndarray
    member_mask: np.ndarray
    halo_mask: np.ndarray

    @property
    def n_held(self) -> int:
        return len(self.my_views)


def plan_clusters(
    cameras: Cameras,
    n_clusters: int,
    pid: int,
    halo_threshold: float = 0.25,
) -> ClusterPlan:
    V = cameras.num_views
    assign = cluster_views(cameras, n_clusters)
    halos = cluster_halos(cameras, assign, halo_threshold)
    my_views = halos[min(pid, len(halos) - 1)]
    member = assign == pid
    halo = np.zeros((V,), bool)
    halo[my_views] = True
    return ClusterPlan(
        assign=assign, my_views=my_views, member_mask=member, halo_mask=halo
    )


# ----------------------------------------------------------------------
# Cross-process exchange (host-level collectives via multihost_utils).
# ----------------------------------------------------------------------


def _allgather_concat(arrays: list[np.ndarray], n_local: int):
    """Gather variable-length per-process rows; returns (concat list in
    pid order, counts (nproc,)).

    Every array in `arrays` shares leading dim `n_local`; each process may
    bring a different n_local. Pads to the global max, gathers, unpads.
    Single-process: identity.
    """
    nproc = jax.process_count()
    if nproc == 1:
        return [np.asarray(a) for a in arrays], np.array([n_local])
    from jax.experimental import multihost_utils

    counts = np.asarray(
        multihost_utils.process_allgather(
            np.full((1,), n_local, np.int32), tiled=True
        )
    ).reshape(-1)
    m = int(counts.max())
    out = []
    for a in arrays:
        a = np.asarray(a)
        pad = np.zeros((m - a.shape[0],) + a.shape[1:], a.dtype)
        stacked = np.asarray(
            multihost_utils.process_allgather(
                np.concatenate([a, pad], axis=0)
            )
        )  # (nproc, m, ...)
        out.append(
            np.concatenate(
                [stacked[p, : counts[p]] for p in range(nproc)], axis=0
            )
        )
    return out, counts


def _gather_state(state: PatchState, prio: np.ndarray):
    """Gather every process's PatchState rows, concatenated in canonical
    priority order (process-count independent). Returns (PatchState, prio)."""
    leaves = [
        np.asarray(state.position),
        np.asarray(state.normal),
        np.asarray(state.ref),
        np.asarray(state.vis),
        np.asarray(state.cand),
        np.asarray(state.alive),
        np.asarray(state.color),
        np.asarray(prio),
    ]
    gathered, _ = _allgather_concat(leaves, state.capacity)
    order = np.argsort(gathered[7], kind="stable")
    g = [a[order] for a in gathered]
    return (
        PatchState.create(
            g[0], g[1], g[2], g[3], cand=g[4], alive=g[5], color=g[6]
        ),
        g[7],
    )


# ----------------------------------------------------------------------
# Local <-> global view-space mapping.
# ----------------------------------------------------------------------


class _LocalViews:
    """Maps a global-view-space PatchState into the process's halo-local
    view space (for the image-touching stages) and back."""

    def __init__(self, cameras: Cameras, plan: ClusterPlan):
        self.ids = jnp.asarray(plan.my_views, jnp.int32)
        V = cameras.num_views
        inv = np.full((V,), -1, np.int32)
        inv[plan.my_views] = np.arange(len(plan.my_views), dtype=np.int32)
        self.inv = jnp.asarray(inv)
        self.cams = jax.tree.map(lambda a: a[self.ids], cameras)
        self.V = V

    def to_local(self, state: PatchState) -> PatchState:
        return dataclasses.replace(
            state,
            ref=self.inv[state.ref],
            vis=state.vis[:, self.ids],
            cand=state.cand[:, self.ids],
        )

    def to_global(self, local: PatchState, template: PatchState) -> PatchState:
        B = local.capacity
        vis = jnp.zeros((B, self.V), bool).at[:, self.ids].set(local.vis)
        cand = jnp.zeros((B, self.V), bool).at[:, self.ids].set(local.cand)
        return dataclasses.replace(
            local, ref=template.ref, vis=vis, cand=cand
        )


# ----------------------------------------------------------------------
# Driver.
# ----------------------------------------------------------------------


def densify_clustered(
    scene,
    config: PipelineConfig = PipelineConfig(),
    seed_points: np.ndarray | None = None,
    halo_threshold: float = 0.25,
    image_loader=None,
    n_clusters: int | None = None,
) -> DensifyResult:
    """End-to-end densification with per-process image ownership.

    Every process calls this with the same cameras/config; each holds only
    its cluster's images + halo. `image_loader(view_ids) -> (n, H, W)
    float32` lets callers avoid ever materializing the full stack (the
    point of the partitioning); without it the local subset is sliced from
    `scene.images`. Returns the SAME full cloud on every process.
    """
    pid = jax.process_index()
    nproc = jax.process_count()
    cameras = scene.cameras
    V = cameras.num_views
    metrics = StageMetrics()
    plan = plan_clusters(
        cameras, n_clusters or nproc, pid, halo_threshold
    )
    lv = _LocalViews(cameras, plan)
    if image_loader is not None:
        images_local = np.asarray(image_loader(plan.my_views))
    else:
        images_local = np.asarray(scene.images)[plan.my_views]
    images_local = jnp.asarray(images_local)
    held_bytes = int(images_local.size * images_local.dtype.itemsize)
    metrics.count("images_held", plan.n_held)
    metrics.count("images_total", V)
    metrics.count("image_bytes_held", held_bytes)
    log.info(
        "clustered densify: process %d/%d owns %d member views, holds "
        "%d/%d images (%.1f MB)",
        pid, nproc, int(plan.member_mask.sum()), plan.n_held, V,
        held_bytes / 1e6,
    )
    halo_j = jnp.asarray(plan.halo_mask)

    scale = config.organizer.grid_scale
    grids = make_grids(
        cameras, scale, config.organizer.max_patches_per_cell
    )

    # ---- seed stage: partition by reference-view cluster -------------
    with metrics.stage("seed"):
        if seed_points is None:
            # Each process seeds from ITS halo subset and keeps the points
            # whose reference (nearest global camera) it owns — the seed
            # analog of the truncated-support semantics.
            pts_l, _, _ = generate_seed_points(
                images_local, lv.cams, config.matching
            )
            seed_points_np = np.asarray(pts_l)
        else:
            seed_points_np = np.asarray(seed_points, np.float32)
            if seed_points_np.shape[0] > config.seed.max_seeds:
                seed_points_np = seed_points_np[: config.seed.max_seeds]
        d = np.linalg.norm(
            seed_points_np[:, None, :] - np.asarray(cameras.C)[None, :, :],
            axis=-1,
        )
        ref_np = np.argmin(d, axis=1)
        mine = plan.member_mask[ref_np]
        my_points = seed_points_np[mine]
        # Canonical seed priorities: the original seed index when seeds
        # are shared input; a pid-offset index for locally generated seeds
        # (still a deterministic total order at any fixed clustering).
        if seed_points is None:
            my_prio = pid * 10_000_000 + np.nonzero(mine)[0]
        else:
            my_prio = np.nonzero(mine)[0].astype(np.int64)
        state = create_patches_from_points(
            cameras, my_points, config.optimize, config.seed
        )
        # Halo truncation: the documented clustered-visibility semantics.
        state = dataclasses.replace(
            state,
            vis=state.vis & halo_j[None, :],
            cand=state.cand & halo_j[None, :],
        )

    with metrics.stage("seed_refine"):
        loc = lv.to_local(state)
        if loc.capacity:
            loc = filter_by_error(
                images_local, lv.cams, loc, config.seed.texture_size,
                config.optimize,
            )
        keep = np.asarray(loc.alive)
        state = lv.to_global(loc, state)
        state = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[keep]), state)
        my_prio = my_prio[keep]
        loc = lv.to_local(state)
        if state.capacity:
            loc = optimize_patches(
                images_local, lv.cams, loc, config.seed.texture_size,
                config.optimize,
            )
        state = lv.to_global(loc, state)
    n_seeds = state.capacity
    log.info("clustered: process %d refined %d/%d seeds", pid, n_seeds,
             int(mine.sum()))

    # Expansion-specific NM budget (single-host driver parity).
    expand_opt = config.optimize
    if config.expand.max_iterations > 0:
        expand_opt = dataclasses.replace(
            config.optimize, max_iterations=config.expand.max_iterations
        )

    def global_insert(st: PatchState, prio: np.ndarray, base_total: int):
        """Globally-deterministic insertion of every process's candidates.

        Exchanges (cells, alive, prio) — the only per-round collective —
        then every process replays the same claim on the canonical-order
        list. Returns (my accepted mask, my accepted global ranks,
        n_accepted_global); updates `grids` in the enclosing scope.
        """
        nonlocal grids
        cells = np.asarray(
            candidate_cells(grids, cameras, st.position, st.vis, scale)
        )
        alive = np.asarray(st.alive)
        (cells_g, alive_g, prio_g), counts = _allgather_concat(
            [cells.astype(np.int32), alive, np.asarray(prio)],
            st.capacity,
        )
        order = np.argsort(prio_g, kind="stable")
        n_g = len(order)
        if n_g == 0:
            return np.zeros((0,), bool), np.zeros((0,), np.int64), 0
        # Pad the claim batch to a power-of-two bucket: one compiled
        # contest per bucket shape instead of one per round.
        cap = 256
        while cap < n_g:
            cap *= 2
        cells_p = np.full((cap, V), -1, np.int32)
        cells_p[:n_g] = cells_g[order]
        alive_p = np.zeros((cap,), bool)
        alive_p[:n_g] = alive_g[order]
        gids = base_total + np.arange(cap, dtype=np.int32)
        accepted_sorted, grids = bulk_try_insert(
            grids,
            jnp.asarray(cells_p),
            jnp.asarray(alive_p),
            jnp.asarray(gids),
            config.organizer.min_grids_to_accept,
        )
        accepted_sorted = np.asarray(accepted_sorted)[:n_g]
        # Global rank of each accepted candidate (canonical order).
        rank_sorted = np.cumsum(accepted_sorted) - 1
        accepted = np.zeros((n_g,), bool)
        accepted[order] = accepted_sorted
        rank = np.zeros((n_g,), np.int64)
        rank[order] = rank_sorted
        lo = int(np.sum(counts[:pid]))
        my_acc = accepted[lo : lo + st.capacity]
        my_rank = rank[lo : lo + st.capacity]
        return my_acc, my_rank, int(accepted_sorted.sum())

    def take(st: PatchState, keep: np.ndarray) -> PatchState:
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[keep]), st)

    with metrics.stage("expand"):
        my_acc, my_rank, total = global_insert(state, my_prio, 0)
        state = take(state, my_acc)
        rank = my_rank[my_acc]
        log.info(
            "clustered: %d/%d seeds inserted globally (process %d holds %d)",
            total, int(np.sum(my_acc)), pid, state.capacity,
        )
        frontier, f_rank = state, rank
        for round_idx in range(config.expand.max_rounds):
            if total >= config.expand.max_patches:
                break
            expandable = np.asarray(
                frontier.alive
                & (
                    frontier.num_visible()
                    >= config.expand.min_visible_views_to_expand
                )
            )
            frontier = take(frontier, expandable)
            f_rank = f_rank[expandable]
            cand = make_expansion_candidates(cameras, frontier, scale)
            # Canonical candidate priority: accepted-rank * 4 + direction
            # (process-count independent; make_expansion_candidates orders
            # [+x | -x | +y | -y] blocks of the local frontier).
            dirs = np.repeat(np.arange(4), len(f_rank))
            cand_prio = np.tile(f_rank, 4) * 4 + dirs
            # Halo truncation is inherited from the parent vis; refine +
            # filter locally against the held images.
            loc = lv.to_local(cand)
            if loc.capacity:
                loc = optimize_patches(
                    images_local, lv.cams, loc,
                    config.expand.texture_size, expand_opt,
                )
            gcand = lv.to_global(loc, cand)
            vis_n, cand_n = classify_views(
                cameras, gcand.position, gcand.normal, gcand.ref,
                config.optimize.visible_angle,
                config.optimize.candidate_angle,
            )
            gcand = dataclasses.replace(
                gcand,
                vis=vis_n & halo_j[None, :],
                cand=cand_n & halo_j[None, :],
            )
            loc = lv.to_local(gcand)
            if loc.capacity:
                loc = filter_by_error(
                    images_local, lv.cams, loc,
                    config.expand.texture_size, expand_opt,
                )
            gcand = lv.to_global(loc, gcand)
            my_acc, my_rank, n_new = global_insert(gcand, cand_prio, total)
            log.info(
                "clustered round %d: process %d cand=%d, global accepted=%d",
                round_idx, pid, gcand.capacity, n_new,
            )
            if n_new == 0:
                break
            new_patches = take(gcand, my_acc)
            state = state.concatenate(new_patches)
            rank = np.concatenate([rank, my_rank[my_acc]])
            total += n_new
            frontier, f_rank = new_patches, my_rank[my_acc]
    metrics.count("patches_after_expand", total)

    with metrics.stage("color"):
        # Color from the held halo views BEFORE the exchange (pixels never
        # cross processes).
        if scene.colors is not None and state.capacity:
            colors_local = jnp.asarray(
                np.asarray(scene.colors)[plan.my_views]
            )
            col = compute_color(lv.cams, colors_local, state.position)
            state = dataclasses.replace(state, color=col)

    with metrics.stage("filter"):
        # One full exchange of the accepted patches (geometry + masks —
        # never pixels), then the replicated deterministic filter stage,
        # identical on every process.
        full, _ = _gather_state(state, rank)
        final = run_filters(
            cameras, full, config.filter, config.optimize, scale
        ).compact()
    metrics.count("patches_final", final.capacity)

    log.info("clustered densify done: %s", metrics.summary())
    return DensifyResult(patches=final, metrics=metrics)
