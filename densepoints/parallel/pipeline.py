"""Multi-device end-to-end densification.

The single-host driver (pmvs/pipeline.py) with its two hot stages swapped
for the sharded versions: patch refinement runs pjit-partitioned over the
mesh's patch axis (zero collectives) and occupancy insertion agrees across
devices via the pmin claim merge (parallel/distributed.py). Host-side
orchestration — seeding, track assembly, compaction between rounds, export
— is unchanged; seeds come from the same deterministic path on every host.

Scaling-efficiency measurement hooks: `densify_distributed` reports
patches/sec for the refine stages so the 1-chip vs N-device ratio
(BASELINE.md target >= 0.7) falls out of the StageMetrics counters.
"""
from __future__ import annotations

import dataclasses
import time

import jax.numpy as jnp

from densepoints.config import PipelineConfig
from densepoints.io.scene import Scene
from densepoints.parallel.distributed import (
    distributed_insert,
    distributed_refine_step,
    shard_state,
)
from densepoints.parallel.mesh import make_mesh
from densepoints.pmvs.expand import make_expansion_candidates
from densepoints.pmvs.filter import run_filters
from densepoints.pmvs.optimize import filter_by_error, optimize_patches
from densepoints.pmvs.organizer import make_grids
from densepoints.pmvs.pipeline import DensifyResult
from densepoints.pmvs.seed import (
    create_patches_from_points,
    generate_seed_points,
)
from densepoints.pmvs.visibility import compute_color
from densepoints.utils import StageMetrics, log

__all__ = ["densify_distributed"]


def densify_distributed(
    scene: Scene,
    config: PipelineConfig = PipelineConfig(),
    mesh=None,
) -> DensifyResult:
    if mesh is None:
        mesh = make_mesh(config.parallel.num_devices or None)
    metrics = StageMetrics()
    cameras = scene.cameras
    images = jnp.asarray(scene.images)
    n_dev = mesh.devices.size
    log.info("distributed densify over %d devices", n_dev)

    with metrics.stage("seed"):
        points, _, _ = generate_seed_points(images, cameras, config.matching)
        state = create_patches_from_points(
            cameras, points, config.optimize, config.seed
        )

    with metrics.stage("seed_refine"):
        t0 = time.perf_counter()
        sharded = shard_state(state, mesh)
        refined = distributed_refine_step(
            images, cameras, sharded, config.seed.texture_size, config.optimize
        )
        refined.position.block_until_ready()
        dt = time.perf_counter() - t0
        metrics.count("seed_refine_patches_per_sec", state.capacity / max(dt, 1e-9))
        state = refined.compact()
    log.info("seeds surviving sharded refine: %d", state.capacity)

    # Wavefront expansion with sharded refine + collective insertion.
    grids = make_grids(cameras, config.organizer.grid_scale)
    ids0 = jnp.arange(state.capacity, dtype=jnp.int32)
    sharded = shard_state(state, mesh)
    pad_ids = jnp.arange(sharded.capacity, dtype=jnp.int32)
    accepted, grids = distributed_insert(
        mesh, grids, cameras, sharded, pad_ids, config.organizer
    )
    state = sharded.masked(accepted).compact()
    frontier = state

    with metrics.stage("expand"):
        for round_idx in range(config.expand.max_rounds):
            if frontier.capacity == 0 or state.capacity >= config.expand.max_patches:
                break
            expandable = frontier.alive & (
                frontier.num_visible()
                >= config.expand.min_visible_views_to_expand
            )
            frontier = frontier.masked(expandable).compact()
            if frontier.capacity == 0:
                break
            cand = make_expansion_candidates(
                cameras, frontier, config.organizer.grid_scale
            )
            cand = shard_state(cand, mesh)
            cand = distributed_refine_step(
                images, cameras, cand, config.expand.texture_size, config.optimize
            )
            base = state.capacity
            gids = base + jnp.arange(cand.capacity, dtype=jnp.int32)
            accepted, grids = distributed_insert(
                mesh, grids, cameras, cand, gids, config.organizer
            )
            new_patches = cand.masked(accepted).compact()
            log.info(
                "distributed round %d: frontier=%d accepted=%d total=%d",
                round_idx,
                frontier.capacity,
                new_patches.capacity,
                base + new_patches.capacity,
            )
            if new_patches.capacity == 0:
                break
            state = state.concatenate(new_patches)
            frontier = new_patches
    metrics.count("patches_after_expand", state.capacity)

    with metrics.stage("filter"):
        state = run_filters(
            cameras,
            state,
            config.filter,
            config.optimize,
            config.organizer.grid_scale,
        )
        state = state.compact()
    metrics.count("patches_final", state.capacity)

    with metrics.stage("color"):
        if scene.colors is not None and state.capacity:
            color = compute_color(
                cameras, jnp.asarray(scene.colors), state.position
            )
            state = dataclasses.replace(state, color=color)

    log.info("distributed densify done: %s", metrics.summary())
    return DensifyResult(patches=state, metrics=metrics)
