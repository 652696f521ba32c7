"""The end-to-end densification driver.

Reference parity: `PMVS::Run` (pmvs.cpp:22-27) = InsertSeeds + ExpandSeeds,
plus the two stages the reference declares but never implements —
`FilterPatches` (pmvs.h:27) and `GetPointCloud` (pmvs.h:21) — which exist
here as `run_filters` and the returned/exported point cloud.

Pipeline: seeds (detect/match/track/triangulate) -> patches -> NCC filter ->
batched simplex optimization -> wavefront expansion -> visibility filters ->
colors -> PLY. Optionally multi-scale coarse-to-fine (multiscale/) and
bundle adjustment (ba/) around the geometric stages.
"""
from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from densepoints.config import PipelineConfig
from densepoints.core.cameras import Cameras
from densepoints.io.ply import write_ply
from densepoints.io.scene import Scene
from densepoints.pmvs.expand import expand_patches
from densepoints.pmvs.filter import run_filters
from densepoints.pmvs.optimize import filter_by_error, optimize_patches
from densepoints.pmvs.patch import PatchState
from densepoints.pmvs.seed import (
    create_patches_from_points,
    generate_seed_points,
)
from densepoints.pmvs.visibility import compute_color
from densepoints.utils import StageMetrics, log

__all__ = ["densify", "DensifyResult"]


@dataclasses.dataclass
class DensifyResult:
    patches: PatchState
    metrics: StageMetrics

    @property
    def positions(self) -> np.ndarray:
        return np.asarray(self.patches.position)

    @property
    def normals(self) -> np.ndarray:
        return np.asarray(self.patches.normal)

    @property
    def colors(self) -> np.ndarray:
        return np.clip(np.asarray(self.patches.color), 0, 255).astype(np.uint8)

    def save_ply(self, path, binary: bool = True):
        write_ply(path, self.positions, self.normals, self.colors, binary=binary)


def _bundle_adjust(cameras: Cameras, points, obs, obs_mask, ba_config,
                   mesh=None):
    """Refine cameras + seed points from the matched tracks (ba/).

    With `mesh`, observations shard over it (run_ba_sharded: one psum per
    segment reduction, camera/point blocks replicated)."""
    import jax

    from densepoints.ba import (
        BAProblem,
        reprojection_rmse,
        run_ba,
        run_ba_sharded,
    )

    T, V = obs_mask.shape
    tp, tv = np.nonzero(obs_mask)
    problem = BAProblem(
        K=cameras.K,
        R0=cameras.E[:, :, :3],
        C0=cameras.C,
        points0=jnp.asarray(points, jnp.float32),
        obs_point=jnp.asarray(tp, jnp.int32),
        obs_view=jnp.asarray(tv, jnp.int32),
        obs_xy=jnp.asarray(obs[tp, tv], jnp.float32),
        obs_mask=jnp.ones((len(tp),), bool),
    )
    if mesh is not None:
        from densepoints.parallel.mesh import replicate

        # Replicated placement first so multi-process meshes see a global
        # array (shard_map then reshards the observation leaves).
        problem = jax.tree.map(
            lambda a: jax.device_put(a, replicate(mesh)), problem
        )
        solve = functools.partial(run_ba_sharded, mesh=mesh)
    else:
        solve = run_ba
    R, C, new_points, _ = solve(
        problem,
        max_outer_iterations=ba_config.max_outer_iterations,
        cg_iterations=ba_config.cg_iterations,
        damping=ba_config.damping,
        robust_delta=ba_config.robust_delta,
    )
    rmse = float(reprojection_rmse(problem, R, C, new_points))
    # Rebuild cameras from the refined extrinsics (host f64 path keeps the
    # decomposition invariants).
    Rn = np.asarray(R, np.float64)
    Cn = np.asarray(C, np.float64)
    Kn = np.asarray(cameras.K, np.float64)
    P = Kn @ np.concatenate([Rn, -Rn @ Cn[:, :, None]], axis=2)
    new_cams = Cameras.from_projection_matrices(
        P, widths=np.asarray(cameras.width), heights=np.asarray(cameras.height)
    )
    return new_cams, np.asarray(new_points), rmse


def densify(
    scene: Scene, config: PipelineConfig = PipelineConfig()
) -> DensifyResult:
    """Run the full PMVS pipeline on a loaded scene (single host).

    `config.runtime` adds the observability/persistence shell: stage
    checkpoints (+ resume from the latest one), debug artifact dumps, and a
    jax.profiler trace (SURVEY.md §5.1/§5.4).
    """
    rt = config.runtime
    if rt.profile_dir:
        import jax

        profile_ctx = jax.profiler.trace(rt.profile_dir)
    else:
        import contextlib

        profile_ctx = contextlib.nullcontext()
    with profile_ctx:
        return _densify_inner(scene, config)


def _checkpoint(rt, state, stage, cameras=None):
    if rt.checkpoint_dir:
        from densepoints.utils.checkpoint import save_checkpoint

        save_checkpoint(
            f"{rt.checkpoint_dir}/{stage}.npz",
            state,
            stage=stage,
            cameras=cameras,
        )


def _densify_inner(
    scene: Scene, config: PipelineConfig
) -> DensifyResult:
    metrics = StageMetrics()
    cameras: Cameras = scene.cameras
    images = jnp.asarray(scene.images)
    rt = config.runtime

    resume_state = resume_stage = None
    if rt.resume and rt.checkpoint_dir:
        from densepoints.utils.checkpoint import (
            latest_checkpoint,
            load_checkpoint,
        )

        ckpt = latest_checkpoint(rt.checkpoint_dir)
        if ckpt is not None:
            resume_state, meta, ckpt_cams = load_checkpoint(ckpt)
            resume_stage = meta.get("stage")
            if ckpt_cams is not None:
                # BA refined the extrinsics before this checkpoint; resume
                # with the geometry the patches were optimized against.
                cameras = ckpt_cams
            log.info("resuming from %s (stage %s)", ckpt, resume_stage)

    if resume_state is not None:
        return _densify_from(
            images, cameras, scene, config, metrics, resume_state,
            resume_stage,
        )

    with metrics.stage("seed"):
        points, obs, obs_mask = generate_seed_points(
            images, cameras, config.matching
        )

    if config.ba.enable and len(points) >= 8:
        with metrics.stage("bundle_adjust"):
            cameras, points, rmse = _bundle_adjust(
                cameras, points, obs, obs_mask, config.ba
            )
            metrics.count("ba_rmse_px", rmse)
            log.info("bundle adjustment: reprojection RMSE %.3f px", rmse)

    with metrics.stage("seed_patches"):
        state = create_patches_from_points(
            cameras, points, config.optimize, config.seed
        )
    metrics.count("seed_points", state.capacity)

    with metrics.stage("seed_filter"):
        state = filter_by_error(
            images, cameras, state, config.seed.texture_size, config.optimize
        )
        state = state.compact()
    metrics.count("seeds_after_ncc", state.capacity)
    log.info("seeds surviving NCC filter: %d", state.capacity)

    with metrics.stage("seed_optimize"):
        if state.capacity:
            state = optimize_patches(
                images, cameras, state, config.seed.texture_size, config.optimize
            )
    _checkpoint(rt, state, "seeds_optimized", cameras)

    return _densify_from(
        images, cameras, scene, config, metrics, state, "seeds_optimized"
    )


def _densify_from(
    images, cameras, scene, config, metrics, state, stage
) -> DensifyResult:
    """Run the pipeline from `stage` onward (also the resume entry point).

    Stages: seeds_optimized -> expanded -> final. Checkpoints carry the
    cameras alongside the patch state, so a resumed run reconstructs with
    the (possibly BA-refined) extrinsics the patches were optimized against.
    """
    rt = config.runtime
    if rt.debug_dir and stage == "seeds_optimized":
        from densepoints.utils import debug

        debug.dump_cloud(rt.debug_dir, "seeds", state)

    if stage == "seeds_optimized":
        if config.multiscale.levels > 1:
            with metrics.stage("expand_multiscale"):
                from densepoints.multiscale import densify_multiscale

                state = densify_multiscale(images, cameras, state, config)
            metrics.count("patches_final", state.capacity)
            _checkpoint(rt, state, "final", cameras)
            stage = "final"
        else:
            with metrics.stage("expand"):
                state, grids = expand_patches(
                    images,
                    cameras,
                    state,
                    config.expand,
                    config.organizer,
                    config.optimize,
                )
            metrics.count("patches_after_expand", state.capacity)
            if rt.debug_dir:
                from densepoints.utils import debug

                debug.dump_occupancy(rt.debug_dir, grids)
            _checkpoint(rt, state, "expanded", cameras)
            stage = "expanded"

    if stage == "expanded":
        with metrics.stage("filter"):
            # Bucket the capacity so the jitted filter programs see a
            # small shape set across runs/rounds (dead padded lanes are
            # masked throughout; an exact-count compact here meant a
            # fresh compile for every distinct final patch count).
            from densepoints.pmvs.expand import _pad_bucket

            state = run_filters(
                cameras,
                _pad_bucket(state),
                config.filter,
                config.optimize,
                config.organizer.grid_scale,
            )
            state = state.compact()
        metrics.count("patches_final", state.capacity)
        _checkpoint(rt, state, "final", cameras)

    with metrics.stage("color"):
        if scene.colors is not None and state.capacity:
            color = compute_color(
                cameras, jnp.asarray(scene.colors), state.position
            )
            state = dataclasses.replace(state, color=color)

    if rt.debug_dir:
        from densepoints.utils import debug

        debug.dump_cloud(rt.debug_dir, "final", state)

    log.info("densify done: %s", metrics.summary())
    return DensifyResult(patches=state, metrics=metrics)
