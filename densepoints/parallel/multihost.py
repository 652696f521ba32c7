"""Multi-HOST distribution: jax.distributed entry point + global-mesh driver.

The reference is single-process OpenMP (SURVEY.md §2.7/§5.8 — no MPI/NCCL/
sockets anywhere); this layer is the multi-process design:

  * `initialize_multihost` wraps `jax.distributed.initialize` (its
    coordination service; coordinator, process count and id are passed
    explicitly, and several processes on one GPU host pin one card each
    with `local_device_ids`); for CI the same entry point runs N CPU processes with virtual devices and
    gloo collectives (tests/parallel/test_multihost.py).
  * one GLOBAL 1-D mesh over all hosts' devices. Patch work shards over it
    exactly as on a single host (the patch axis spans NVLink within a host
    and the network across hosts — patch refinement has ZERO collectives).
  * the seed FRONT-END is view-sharded: each process detects/describes
    only its view slice (`pmvs/seed.py _viewsharded_features`); one small
    keypoint/descriptor all-gather replaces the fully replicated front-end
    of the round-2 design.
  * occupancy grids are VIEW-sharded (each device owns a slice of views'
    grids, `viewsharded_insert`): insertion claims route to the owning
    device and the >=2-grids acceptance rule is a (P,)-int32 psum — no
    V*Hg*Wg replication or min-merge anywhere.
  * PatchState stays SHARDED over the mesh across expansion rounds: only
    (P,) acceptance/visibility vectors and scalar counts reach the host
    each round (the round-2 design all-gathered every PatchState leaf per
    refine — ~100 MB of DCN per round at the 1e6-patch cap; now the only
    full gather is the one final pull for filtering/export). Compaction is
    a jitted on-device gather driven by replicated index vectors, so every
    process executes the same program on the same global arrays.

Determinism: all contention is resolved by global candidate ids
(scatter-min), and compaction indices are derived from replicated
vectors — the N-host cloud equals the 1-host cloud (asserted by the
multi-process CPU test).

Images are REPLICATED to every process by design: the warp+NCC sampling
path may touch any view's pixels for any patch each Nelder-Mead iteration,
and a DTU-scale stack (49 x 1600 x 1200 f32, 376 MB) is ~0.5% of an
80 GB card — far
cheaper than per-iteration cross-host window fetches. The per-host
partitioning axis that matters (detection work, occupancy ownership,
patch blocks) is sharded as described above. See docs/ARCHITECTURE.md.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from densepoints.config import PipelineConfig
from densepoints.parallel.distributed import (
    pad_views,
    refine_step_once,
    viewsharded_insert,
)
from densepoints.parallel.mesh import PATCH_AXIS, replicate
from densepoints.pmvs.expand import make_expansion_candidates
from densepoints.pmvs.filter import run_filters
from densepoints.pmvs.optimize import (
    filter_by_error_once,
    optimize_patches_once,
)
from densepoints.pmvs.organizer import candidate_cells, make_grids
from densepoints.pmvs.patch import PatchState
from densepoints.pmvs.pipeline import DensifyResult
from densepoints.pmvs.seed import (
    create_patches_from_points,
    generate_seed_points,
)
from densepoints.pmvs.visibility import compute_color
from densepoints.utils import StageMetrics, log

__all__ = [
    "initialize_multihost",
    "global_mesh",
    "densify_multihost",
]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    platform: str | None = None,
    local_device_ids: list[int] | None = None,
):
    """Join (or form) the multi-process job. Returns (process_id, n_processes).

    Pass the coordinator (`host:port`), process count and id explicitly:
    a plain GPU host has no cluster environment to detect them from.
    Several processes on one multi-GPU host must each pin their own card
    with `local_device_ids` (e.g. [process_id]); without it every process
    opens every card and all but the first run out of device memory.
    `platform="cpu"` selects gloo collectives so CI can run real
    multi-process programs without GPUs.
    """
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    # Persistent compilation cache: in a multi-process job every process
    # pays the full cold compile otherwise.
    from densepoints.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    log.info(
        "multihost: process %d/%d, %d global devices (%d local)",
        jax.process_index(),
        jax.process_count(),
        len(jax.devices()),
        len(jax.local_devices()),
    )
    return jax.process_index(), jax.process_count()


def global_mesh():
    """1-D mesh over ALL devices of ALL processes (patch axis)."""
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (PATCH_AXIS,))


def _bucket(n: int, n_dev: int, minimum: int = 256) -> int:
    """Next power-of-two capacity >= max(n, minimum), padded to a multiple
    of the mesh size (keeps the jitted round shapes few AND shardable)."""
    target = minimum
    while target < n:
        target *= 2
    return -(-target // n_dev) * n_dev


class _ShardedOps:
    """Per-mesh jitted stage functions over a SHARDED PatchState.

    Everything here takes/returns dim-0-sharded patch trees; only `small`
    (and insert's acceptance vector) produce replicated host-readable
    outputs.
    """

    def __init__(self, mesh, cameras_rep, images_rep, config, spec, Vp):
        self.mesh = mesh
        self.n_dev = mesh.devices.size
        self.shard = NamedSharding(mesh, P(PATCH_AXIS))
        self.rep = replicate(mesh)
        self.cams = cameras_rep
        self.images = images_rep
        self.config = config
        self.spec = spec  # replicated OccupancyGrids layout (never written)
        self.Vp = Vp
        scale = config.organizer.grid_scale

        self.small = jax.jit(
            lambda st: (st.alive, jnp.sum(st.vis, axis=1).astype(jnp.int32)),
            out_shardings=self.rep,
        )

        def _take(st, idx, valid):
            # Pad lanes are ZEROED, not left as copies of the gathered
            # fill index: the batched Nelder-Mead's global early exit
            # couples every lane's iteration count to the whole batch, so
            # pad content must be bit-identical regardless of which code
            # path produced the state (fresh run vs checkpoint resume) —
            # zeros match the single-host _pad_bucket convention.
            out = jax.tree.map(lambda a: a[idx], st)
            out = jax.tree.map(
                lambda a: jnp.where(
                    valid.reshape((-1,) + (1,) * (a.ndim - 1)),
                    a,
                    jnp.zeros_like(a),
                ),
                out,
            )
            return dataclasses.replace(out, alive=out.alive & valid)

        self.take = jax.jit(_take, out_shardings=self.shard)

        self.candidates = jax.jit(
            lambda cams, st: make_expansion_candidates(cams, st, scale),
            out_shardings=self.shard,
        )

        # Jit the UNSLICED stage bodies and drive the `max_refine_batch`
        # slice loop from the driver (self._sliced): jitting the public
        # `optimize_patches`/`filter_by_error` wrappers would unroll their
        # slice loop into one XLA program and silently defeat the memory
        # bound on exactly the path where DTU-scale batches occur
        # (ADVICE r3 medium).
        self._refine_jit = jax.jit(
            refine_step_once,
            static_argnames=("texture_size", "optimize_config"),
            out_shardings=self.shard,
        )
        self._seed_filter_jit = jax.jit(
            filter_by_error_once,
            static_argnames=("texture_size", "config"),
            out_shardings=self.shard,
        )
        self._seed_optimize_jit = jax.jit(
            optimize_patches_once,
            static_argnames=("texture_size", "config"),
            out_shardings=self.shard,
        )
        self.refine = functools.partial(self._sliced, self._refine_jit)
        self.seed_filter = functools.partial(
            self._sliced, self._seed_filter_jit
        )
        self.seed_optimize = functools.partial(
            self._sliced, self._seed_optimize_jit
        )

        V = spec.cells.shape[0]

        def _cells(cams, position, vis):
            cells = candidate_cells(spec, cams, position, vis, scale)
            return jnp.pad(
                cells, ((0, 0), (0, Vp - V)), constant_values=-1
            )

        self.cells = jax.jit(_cells)

        self.gather = jax.jit(lambda st: st, out_shardings=self.rep)

        def _concat(parts):
            return jax.tree.map(
                lambda *ls: jnp.concatenate(ls, axis=0), *parts
            )

        self.concat = jax.jit(_concat, out_shardings=self.shard)

    def _sliced(self, fn_jit, images, cameras, state, texture_size, config):
        """Run a jitted per-patch stage over `max_refine_batch` slices.

        The sharded analog of pmvs.optimize._sliced: slices are extracted
        with the jitted replicated-index gather (`self.take`, SPMD-safe on
        multi-process global arrays) and executed one dispatch at a time
        with a host sync in between, so at most one slice's NM workspace is
        live on the devices.
        """
        B = state.capacity
        mb = config.max_refine_batch
        if mb <= 0 or B <= mb:
            return fn_jit(images, cameras, state, texture_size, config)
        mb = -(-mb // self.n_dev) * self.n_dev  # shardable slice width
        valid_full = jax.device_put(jnp.ones((mb,), bool), self.rep)
        outs = []
        for lo in range(0, B, mb):
            n = min(mb, B - lo)
            idx = np.zeros((mb,), np.int32)
            idx[:n] = np.arange(lo, lo + n, dtype=np.int32)
            if n == mb:
                valid = valid_full
            else:
                v = np.zeros((mb,), bool)
                v[:n] = True
                valid = jax.device_put(jnp.asarray(v), self.rep)
            sl = self.take(
                state, jax.device_put(jnp.asarray(idx), self.rep), valid
            )
            out = fn_jit(images, cameras, sl, texture_size, config)
            # Serialize slices: async dispatch would hold every slice's
            # execution workspace live at once — the point of slicing.
            jax.block_until_ready(out.position)
            outs.append(out)
        full = self.concat(outs)
        if full.capacity == B:
            return full
        idx = jax.device_put(
            jnp.arange(B, dtype=jnp.int32), self.rep
        )
        ones = jax.device_put(jnp.ones((B,), bool), self.rep)
        return self.take(full, idx, ones)

    def place(self, state: PatchState) -> PatchState:
        """Pad capacity to a shardable bucket and device_put sharded."""
        cap = _bucket(state.capacity, self.n_dev)
        pad = cap - state.capacity
        if pad:
            state = jax.tree.map(
                lambda a: jnp.concatenate(
                    [
                        jnp.asarray(a),
                        jnp.zeros((pad,) + a.shape[1:], jnp.asarray(a).dtype),
                    ],
                    axis=0,
                ),
                state,
            )
        return jax.tree.map(
            lambda a: jax.device_put(jnp.asarray(a), self.shard), state
        )

    def compact_to(self, state: PatchState, keep: np.ndarray) -> PatchState:
        """Device-side compaction by a replicated host-computed index set."""
        idx = np.nonzero(keep)[0].astype(np.int32)
        cap = _bucket(len(idx), self.n_dev)
        valid = np.zeros((cap,), bool)
        valid[: len(idx)] = True
        idx_pad = np.zeros((cap,), np.int32)
        idx_pad[: len(idx)] = idx
        return self.take(
            state,
            jax.device_put(jnp.asarray(idx_pad), self.rep),
            jax.device_put(jnp.asarray(valid), self.rep),
        )

    def insert(self, gpad, state, gids):
        """Returns (accepted (P,) bool, DEVICE-replicated, new grids)."""
        cells = self.cells(self.cams, state.position, state.vis)
        return viewsharded_insert(
            self.mesh,
            gpad,
            cells,
            state.alive,
            jax.device_put(jnp.asarray(gids), self.rep),
            self.config.organizer.min_grids_to_accept,
        )


def _ckpt_stage(ckpt) -> str:
    """Stage name of a checkpoint path ("" if none) — from the filename
    (checkpoints are written as `{stage}.npz`)."""
    return "" if ckpt is None else ckpt.stem


def _replicated_host_state(ops: _ShardedOps, state: PatchState) -> PatchState:
    """The one deliberate full gather: sharded state -> host numpy."""
    return jax.tree.map(np.asarray, ops.gather(state))


class _Overhead:
    """Per-round distribution-overhead accounting (VERDICT r2 task 5).

    Tracks what actually crosses the device->host boundary each round
    (the small replicated vectors) and what crosses devices (the
    acceptance psum + the candidate-cell reshard into view shards), so
    SCALING artifacts report measured bytes/time instead of virtual-mesh
    "efficiency". All other round work is patch-sharded with zero
    collectives.
    """

    def __init__(self):
        self.host_bytes = 0
        self.host_sync_s = 0.0
        self.collective_bytes = 0

    def pull(self, *arrays):
        """Materialize small replicated device vectors, timed."""
        import time as _time

        t = _time.perf_counter()
        out = tuple(np.asarray(a) for a in arrays)
        self.host_sync_s += _time.perf_counter() - t
        self.host_bytes += sum(o.nbytes for o in out)
        return out if len(out) > 1 else out[0]

    def count_insert(self, P: int, Vp: int):
        # psum of (P,) int32 win counts + (P, Vp) int32 cell reshard.
        self.collective_bytes += P * 4 + P * Vp * 4


def densify_multihost(
    scene,
    config: PipelineConfig = PipelineConfig(),
    mesh=None,
    seed_points: np.ndarray | None = None,
) -> DensifyResult:
    """End-to-end densification over a (hosts x devices) global mesh.

    Every process calls this with the SAME scene/config and receives the
    SAME result. `seed_points` short-circuits the seeding front-end (used
    by tests and by callers that bring their own sparse reconstruction).

    Seed-stage semantics match the single-host `densify` exactly:
    create patches -> NCC filter -> compact -> optimize (pipeline.py
    seed_filter/seed_optimize stages), so `--distributed` on one device
    produces the same cloud as the default path.
    """
    if mesh is None:
        mesh = global_mesh()
    metrics = StageMetrics()
    cameras = scene.cameras
    n_dev = mesh.devices.size
    rt = config.runtime
    log.info(
        "multihost densify: %d devices over %d processes",
        n_dev,
        jax.process_count(),
    )
    # Elastic resume (SURVEY.md §5.3): a job that lost (or gained) hosts
    # restarts with the new process count and resumes from the latest
    # stage checkpoint — the sharded program is process-count agnostic, so
    # the same checkpoint serves any mesh size.
    resume_state = resume_stage = None
    if rt.resume and rt.checkpoint_dir:
        from densepoints.utils.checkpoint import (
            latest_checkpoint,
            load_checkpoint,
        )

        ckpt = latest_checkpoint(rt.checkpoint_dir)
        if jax.process_count() > 1:
            # Checkpoints are written by process 0 only, so
            # `checkpoint_dir` must be a SHARED filesystem in multi-process
            # jobs. Agree on process 0's resume decision before branching:
            # divergent fresh-run/resume programs would issue mismatched
            # collectives (hang/corruption, ADVICE r3 low).
            from jax.experimental import multihost_utils

            stages = ["", "seeds_optimized", "expanded", "final"]
            stage = _ckpt_stage(ckpt)
            local_code = stages.index(stage) if stage in stages else -1
            code = int(
                multihost_utils.broadcast_one_to_all(
                    np.int32(local_code)
                )
            )
            if code != local_code:
                raise RuntimeError(
                    "multihost resume: process %d sees checkpoint stage %r "
                    "but process 0 decided %r — runtime.checkpoint_dir "
                    "(%s) must be on a filesystem shared by every process"
                    % (
                        jax.process_index(),
                        stage,
                        stages[code] if 0 <= code < len(stages) else code,
                        rt.checkpoint_dir,
                    )
                )
            if code == 0:
                ckpt = None
        if ckpt is not None:
            resume_state, meta, ckpt_cams = load_checkpoint(ckpt)
            resume_stage = meta.get("stage")
            if ckpt_cams is not None:
                cameras = ckpt_cams
            log.info(
                "multihost: resuming from %s (stage %s)", ckpt, resume_stage
            )

    rep = replicate(mesh)
    images_rep = jax.device_put(jnp.asarray(scene.images), rep)
    cams_rep = jax.tree.map(
        lambda a: jax.device_put(jnp.asarray(a), rep), cameras
    )

    if resume_stage == "final":
        final = jax.tree.map(jnp.asarray, resume_state)
        log.info("multihost: checkpoint already final (%d patches)",
                 final.capacity)
        return DensifyResult(patches=final, metrics=metrics)

    with metrics.stage("seed"):
        if resume_state is not None:
            state_host = jax.tree.map(np.asarray, resume_state)
        else:
            if seed_points is None:
                points, obs, obs_mask = generate_seed_points(
                    jnp.asarray(scene.images), cameras, config.matching,
                    mesh=mesh,
                )
                if config.ba.enable and len(points) >= 8:
                    from densepoints.pmvs.pipeline import _bundle_adjust

                    cameras, points, rmse = _bundle_adjust(
                        cameras, points, obs, obs_mask, config.ba, mesh=mesh
                    )
                    cams_rep = jax.tree.map(
                        lambda a: jax.device_put(jnp.asarray(a), rep), cameras
                    )
                    metrics.count("ba_rmse_px", rmse)
            else:
                points = seed_points
            state_host = jax.tree.map(
                np.asarray,
                create_patches_from_points(
                    cameras, points, config.optimize, config.seed
                ),
            )

    scale = config.organizer.grid_scale
    spec = make_grids(
        cameras, scale, config.organizer.max_patches_per_cell
    )
    V = spec.cells.shape[0]
    gpad = pad_views(spec, n_dev)
    Vp = gpad.cells.shape[0]
    gpad = dataclasses.replace(
        gpad,
        cells=jax.device_put(
            gpad.cells, NamedSharding(mesh, P(PATCH_AXIS))
        ),
    )
    ops = _ShardedOps(mesh, cams_rep, images_rep, config, spec, Vp)

    with metrics.stage("seed_refine"):
        state = ops.place(state_host)
        if resume_stage == "seeds_optimized":
            # Checkpoint is already filtered + optimized.
            alive, _ = ops.small(state)
            state = ops.compact_to(state, np.asarray(alive))
            n_seeds = int(np.sum(np.asarray(alive)))
        else:
            # Single-host seed semantics: NCC filter -> compact -> optimize.
            state = ops.seed_filter(
                images_rep, cams_rep, state, config.seed.texture_size,
                config.optimize,
            )
            alive, _ = ops.small(state)
            state = ops.compact_to(state, np.asarray(alive))
            n_seeds = int(np.sum(np.asarray(alive)))
            if n_seeds:
                state = ops.seed_optimize(
                    images_rep, cams_rep, state, config.seed.texture_size,
                    config.optimize,
                )
    metrics.count("seeds_after_refine", n_seeds)
    log.info("multihost: %d seeds after refine", n_seeds)
    if rt.checkpoint_dir:
        # The gather is a COLLECTIVE (jitted all-gather over the sharded
        # state) — every process must enter it; only the file write is
        # process-0-only (ADVICE r3 high: gating the gather deadlocked
        # multi-process jobs at the first checkpoint).
        host = _replicated_host_state(ops, state)
        if jax.process_index() == 0:
            from densepoints.utils.checkpoint import save_checkpoint

            save_checkpoint(
                f"{rt.checkpoint_dir}/seeds_optimized.npz",
                host,
                stage="seeds_optimized",
                cameras=cameras,
            )

    overhead = _Overhead()
    # Expansion-specific NM budget (same knob as the single-host driver).
    expand_opt = config.optimize
    if config.expand.max_iterations > 0:
        expand_opt = dataclasses.replace(
            config.optimize, max_iterations=config.expand.max_iterations
        )

    # Coarse-to-fine levels (same semantics as the single-host
    # densify_multiscale, pmvs/pipeline.py:238-245): seed insertion +
    # wavefront rounds at the coarsest level, then at each finer level the
    # carried-over patches are re-optimized/re-filtered against the finer
    # textures and expanded further. Level 0 (finest) reuses the full-res
    # ops/grids built above, so levels == 1 is exactly the round-3 flow.
    levels = max(1, config.multiscale.levels)
    if levels > 1:
        from densepoints.multiscale import build_pyramid

        pyramid = build_pyramid(jnp.asarray(scene.images), cameras, levels)

    def expand_rounds(ops_l, gpad_l, cams_l_rep, images_l_rep, state, Vp_l):
        """Seed insertion + wavefront rounds on one pyramid level.

        Returns the level's full sharded state (accepted patches only).
        """
        ids0 = np.arange(state.capacity, dtype=np.int32)
        accepted, gpad_l = ops_l.insert(gpad_l, state, ids0)
        overhead.count_insert(state.capacity, Vp_l)
        alive, nvis = ops_l.small(state)
        accepted, alive, nvis = overhead.pull(accepted, alive, nvis)
        keep = alive & accepted
        state = ops_l.compact_to(state, keep)
        total = int(np.sum(keep))
        log.info("multihost: %d seeds inserted", total)

        # state/frontier stay device-sharded; parts accumulate per-round
        # accepted patches (concatenated once at the end).
        parts = [state]
        frontier = state
        f_alive, f_nvis = overhead.pull(*ops_l.small(frontier))
        for round_idx in range(config.expand.max_rounds):
            if total >= config.expand.max_patches:
                break
            expandable = f_alive & (
                f_nvis >= config.expand.min_visible_views_to_expand
            )
            n_front = int(np.sum(expandable))
            if n_front == 0:
                break
            frontier = ops_l.compact_to(frontier, expandable)
            cand = ops_l.candidates(cams_l_rep, frontier)
            cand = ops_l.refine(
                images_l_rep, cams_l_rep, cand,
                config.expand.texture_size, expand_opt,
            )
            gids = total + np.arange(cand.capacity, dtype=np.int32)
            accepted, gpad_l = ops_l.insert(gpad_l, cand, gids)
            overhead.count_insert(cand.capacity, Vp_l)
            c_alive, c_nv = ops_l.small(cand)
            accepted, c_alive = overhead.pull(accepted, c_alive)
            new_keep = c_alive & accepted
            n_new = int(np.sum(new_keep))
            log.info(
                "multihost round %d: frontier=%d accepted=%d total=%d",
                round_idx,
                n_front,
                n_new,
                total + n_new,
            )
            if n_new == 0:
                break
            new_patches = ops_l.compact_to(cand, new_keep)
            parts.append(new_patches)
            total += n_new
            frontier = new_patches
            f_alive, f_nvis = overhead.pull(*ops_l.small(frontier))
        return (
            parts[0] if len(parts) == 1 else ops_l.concat(parts),
            total,
        )

    with metrics.stage("expand"):
        for li, lvl in enumerate(range(levels - 1, 0, -1)):
            # Coarser levels: fresh ops/grids bound to the level cameras.
            images_l, cams_l = pyramid[lvl]
            images_l_rep = jax.device_put(jnp.asarray(images_l), rep)
            cams_l_rep = jax.tree.map(
                lambda a: jax.device_put(jnp.asarray(a), rep), cams_l
            )
            spec_l = make_grids(
                cams_l, scale, config.organizer.max_patches_per_cell
            )
            gpad_l = pad_views(spec_l, n_dev)
            Vp_l = gpad_l.cells.shape[0]
            gpad_l = dataclasses.replace(
                gpad_l,
                cells=jax.device_put(
                    gpad_l.cells, NamedSharding(mesh, P(PATCH_AXIS))
                ),
            )
            ops_l = _ShardedOps(
                mesh, cams_l_rep, images_l_rep, config, spec_l, Vp_l
            )
            if li > 0:
                # Carried-over patches: refine against this level's finer
                # textures (multiscale/pyramid.py order: optimize ->
                # filter -> compact).
                state = ops_l.place(state_host)
                state = ops_l.seed_optimize(
                    images_l_rep, cams_l_rep, state,
                    config.seed.texture_size, config.optimize,
                )
                state = ops_l.seed_filter(
                    images_l_rep, cams_l_rep, state,
                    config.seed.texture_size, config.optimize,
                )
                alive, _ = ops_l.small(state)
                state = ops_l.compact_to(state, np.asarray(alive))
            log.info(
                "multihost multiscale level %d: %dx%d",
                lvl, int(cams_l.width[0]), int(cams_l.height[0]),
            )
            full_l, _ = expand_rounds(
                ops_l, gpad_l, cams_l_rep, images_l_rep, state, Vp_l
            )
            # Per-level filtering on gathered state (single-host parity).
            host_l = _replicated_host_state(ops_l, full_l)
            lvl_state = run_filters(
                cams_l,
                jax.tree.map(jnp.asarray, host_l),
                config.filter,
                config.optimize,
                scale,
            ).compact()
            state_host = jax.tree.map(np.asarray, lvl_state)

        if levels > 1:
            # Finest level: carried-over refine against full resolution.
            state = ops.place(state_host)
            state = ops.seed_optimize(
                images_rep, cams_rep, state,
                config.seed.texture_size, config.optimize,
            )
            state = ops.seed_filter(
                images_rep, cams_rep, state,
                config.seed.texture_size, config.optimize,
            )
            alive, _ = ops.small(state)
            state = ops.compact_to(state, np.asarray(alive))
        full, total = expand_rounds(
            ops, gpad, cams_rep, images_rep, state, Vp
        )
    metrics.count("patches_after_expand", total)
    metrics.count("overhead_host_bytes", overhead.host_bytes)
    metrics.count("overhead_host_sync_s", round(overhead.host_sync_s, 4))
    metrics.count("overhead_collective_bytes", overhead.collective_bytes)

    with metrics.stage("filter"):
        # The one full gather of the run: filtering/compaction/export need
        # host-addressable arrays.
        host_state = _replicated_host_state(ops, full)
        final = run_filters(
            cameras,
            jax.tree.map(jnp.asarray, host_state),
            config.filter,
            config.optimize,
            scale,
        )
        final = final.compact()
    metrics.count("patches_final", final.capacity)

    with metrics.stage("color"):
        if scene.colors is not None and final.capacity:
            color = compute_color(
                cameras, jnp.asarray(scene.colors), final.position
            )
            final = dataclasses.replace(final, color=color)

    if rt.checkpoint_dir and jax.process_index() == 0:
        from densepoints.utils.checkpoint import save_checkpoint

        save_checkpoint(
            f"{rt.checkpoint_dir}/final.npz",
            jax.tree.map(np.asarray, final),
            stage="final",
            cameras=cameras,
        )
    if rt.debug_dir and jax.process_index() == 0:
        from densepoints.utils import debug

        debug.dump_cloud(rt.debug_dir, "final", final)

    log.info("multihost densify done: %s", metrics.summary())
    return DensifyResult(patches=final, metrics=metrics)
