"""Photometric patch optimization and NCC-based visibility filtering.

Reference parity: `methods/pmvs/optimization.cpp` + `optimization_opencv.cpp`:

  * parametrization (depth, roll, pitch): depth along the reference ray
    RELATIVE to the current position (position' = C + (1+depth)(p - C)),
    compositional rotation of the normal by the reference's explicit
    roll/pitch matrix (optimization.cpp:78-96);
  * objective: mean over non-anchor visible views of (1 - NCC(tex_anchor,
    tex_v)) in [0, 2]; invalid warps score NCC = -1 (-> penalty 2); no
    scorable views -> 2 (optimization_opencv.cpp:14-39). The anchor is the
    FIRST truly-visible view (the reference view itself is excluded from the
    visible list, so textures[0] belongs to the first visible view);
  * solver: Nelder-Mead from x0 = 0 with init step (0.02, 0.2, 0.2),
    <= 500 iterations, eps 1e-4 (optimization_opencv.cpp:55-64), batched
    over every patch at once via ops/simplex.py;
  * filter: per visible non-anchor view NCC against the anchor texture;
    views under `score_threshold` (0.6) are dropped from the visible mask,
    and the patch dies if fewer than `min_visible_views` (3) remain
    (optimization.cpp:98-132).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from densepoints.config import OptimizeConfig
from densepoints.core.cameras import Cameras
from densepoints.ops.ncc import ncc_pairs
from densepoints.ops.simplex import nelder_mead
from densepoints.ops.warp import compact_visible, patch_textures_indexed
from densepoints.pmvs.patch import PatchState

__all__ = [
    "parametrize",
    "unparametrize",
    "patch_ncc_scores",
    "photometric_objective",
    "photometric_objective_allviews",
    "filter_by_error",
    "filter_by_error_once",
    "optimize_patches",
    "optimize_patches_once",
]


def parametrize(cameras: Cameras, position, normal, ref):
    """(depth, roll, pitch) of the current patch pose (optimization.cpp:58-76).

    Informational/diagnostic (the solver always starts at 0 relative).
    """
    C = cameras.C[ref]
    depth = jnp.linalg.norm(position - C, axis=-1)
    x_axis = cameras.x_axis[ref]
    y_axis = jnp.cross(normal, x_axis)
    z_axis = jnp.cross(x_axis, y_axis)
    roll = jnp.arctan2(z_axis[..., 1], z_axis[..., 2])
    pitch = jnp.arctan2(
        -z_axis[..., 0],
        jnp.sqrt(z_axis[..., 1] ** 2 + z_axis[..., 2] ** 2),
    )
    return depth, roll, pitch


def _rotation(roll, pitch):
    """The reference's explicit roll/pitch rotation (optimization.cpp:84-93)."""
    ca, sa = jnp.cos(roll), jnp.sin(roll)
    cb, sb = jnp.cos(pitch), jnp.sin(pitch)
    zero = jnp.zeros_like(ca)
    return jnp.stack(
        [
            jnp.stack([cb, zero, -sb], -1),
            jnp.stack([sa * sb, ca, cb * sa], -1),
            jnp.stack([ca * sb, -sa, ca * cb], -1),
        ],
        -2,
    )  # (..., 3, 3)


def unparametrize(params, position0, normal0, C_ref):
    """Apply relative (depth, roll, pitch) to the starting pose.

    params: (..., 3); position0/normal0/C_ref broadcastable (..., 3).
    """
    depth = params[..., 0:1]
    position = C_ref + (1.0 + depth) * (position0 - C_ref)
    R = _rotation(params[..., 1], params[..., 2])
    normal = jnp.einsum("...ij,...j->...i", R, normal0)
    return position, normal


def patch_ncc_scores(
    images: jax.Array,
    cameras: Cameras,
    position: jax.Array,
    normal: jax.Array,
    ref: jax.Array,
    vis: jax.Array,
    texture_size: int,
    max_score_views: int = 16,
    view_ids: jax.Array | None = None,
    ok: jax.Array | None = None,
):
    """Per-view NCC against the anchor (first visible) view's texture.

    PARITY REFERENCE: gather-based warp + row NCC, compacted per patch.
    Views are compacted to M = min(V, max_score_views) slots per patch
    (work scales with visibility, not scene size); pass explicit
    `view_ids`/`ok` slot arrays to score a chosen view subset instead
    (slot 0 must be the anchor). Returns
    (scores (B, M), view_ids (B, M), ok (B, M)); scores[b, 0] is the anchor
    against itself; slots whose warp is invalid (any corner outside, the
    reference's empty-texture case) or whose anchor is invalid score -1.
    """
    if view_ids is None:
        view_ids, ok = compact_visible(vis, max_score_views)
    tex, valid = patch_textures_indexed(
        images, cameras, position, normal, ref, view_ids, ok, texture_size
    )
    B, M, k, _ = tex.shape
    flat = tex.reshape(B, M, k * k)
    aflat = jnp.broadcast_to(flat[:, :1], flat.shape)
    scores = ncc_pairs(
        aflat.reshape(B * M, k * k), flat.reshape(B * M, k * k)
    ).reshape(B, M)
    pair_valid = valid & valid[:, :1]
    scores = jnp.where(pair_valid, scores, -1.0)
    return scores, view_ids, ok


def photometric_objective(
    images: jax.Array,
    cameras: Cameras,
    position0: jax.Array,
    normal0: jax.Array,
    ref: jax.Array,
    vis: jax.Array,
    texture_size: int,
    max_score_views: int = 16,
):
    """Build the batched objective f(params (B, K, 3)) -> (B, K).

    PARITY REFERENCE ONLY: production refinement dispatches
    `photometric_objective_allviews`; this chunked derivation survives for
    the equivalence tests.

    The reference averages (1 - NCC) over EVERY visible texture
    (optimization_opencv.cpp:25-38); views are scored in anchor-pinned
    chunks of `max_score_views` slots (see `_anchor_chunks`), so
    DTU-scale visibility (V ~ 50) contributes every view to the cost
    instead of silently truncating at the compaction width.
    """
    C_ref = cameras.C[ref]  # (B, 3)
    chunks = _anchor_chunks(vis, max_score_views)

    def f(params: jax.Array) -> jax.Array:
        B, K, _ = params.shape
        pos, nrm = unparametrize(
            params, position0[:, None, :], normal0[:, None, :], C_ref[:, None, :]
        )
        pos = pos.reshape(B * K, 3)
        nrm = nrm.reshape(B * K, 3)
        ref_bk = jnp.repeat(ref, K)
        vis_bk = jnp.repeat(vis, K, axis=0)
        err_sum = jnp.zeros((B * K,), params.dtype)
        n_sum = jnp.zeros((B * K,), jnp.int32)
        for chunk_ids, chunk_ok in chunks:
            scores, _, ok = patch_ncc_scores(
                images, cameras, pos, nrm, ref_bk, vis_bk, texture_size,
                view_ids=jnp.repeat(chunk_ids, K, axis=0),
                ok=jnp.repeat(chunk_ok, K, axis=0),
            )
            counted = ok.at[:, 0].set(False)  # visible slots except anchor
            err_sum = err_sum + jnp.sum(
                jnp.where(counted, 1.0 - scores, 0.0), axis=1
            )
            n_sum = n_sum + jnp.sum(counted, axis=1)
        cost = jnp.where(
            n_sum > 0, err_sum / jnp.maximum(n_sum, 1), 2.0
        )
        return cost.reshape(B, K)

    return f


def _allview_scores(
    images, cameras, position, normal, ref, vis, texture_size, plan=None,
):
    """(B, V) anchor-NCC score grid: Triton kernel on CUDA, XLA elsewhere.

    Every visible non-anchor view is scored in ONE pass. Returns
    (scores (B, V), anchor (B,), anchor_ok (B,)) with -1 at
    invisible/invalid positions (see ops/allview). `plan` is the CUDA
    kernel's slot schedule (`ops.allview.make_plan`); the XLA branch
    ignores it.
    """
    from densepoints.ops.allview import (
        allview_scores_triton,
        allview_scores_xla,
    )

    def _cuda(images, cameras, position, normal, ref, vis):
        return allview_scores_triton(
            images, cameras, position, normal, ref, vis, texture_size,
            plan=plan,
        )

    def _xla(images, cameras, position, normal, ref, vis):
        return allview_scores_xla(
            images, cameras, position, normal, ref, vis, texture_size
        )

    return jax.lax.platform_dependent(
        images, cameras, position, normal, ref, vis,
        cuda=_cuda, default=_xla,
    )


def scoring_path() -> str:
    """Name of the scoring implementation `_allview_scores` lowers to on
    the default backend (the repository's GPUs are CUDA cards)."""
    if jax.default_backend() == "gpu":
        return "allview_scores_triton"
    return "allview_scores_xla"


def photometric_objective_allviews(
    images: jax.Array,
    cameras: Cameras,
    position0: jax.Array,
    normal0: jax.Array,
    ref: jax.Array,
    vis: jax.Array,
    texture_size: int,
):
    """All-views batched objective f(params (B, K, 3)) -> (B, K).

    Identical semantics to `photometric_objective` (mean over every
    visible non-anchor view of 1 - NCC vs the anchor texture; invalid
    warps score -1 -> penalty 2; no scorable views -> 2), built on the
    single-pass (B, V) score grid instead of anchor-pinned chunks.
    """
    from densepoints.ops.allview import make_plan

    # The slot plan depends on the mask alone: built once, outside the
    # solver loop.
    plan = make_plan(vis)
    payload = plan.payload  # (B, V) visible non-anchor views
    n_payload = jnp.sum(payload, axis=1)  # static across evals

    def f(params: jax.Array) -> jax.Array:
        K = params.shape[1]
        costs = []
        for kk in range(K):
            pos, nrm = unparametrize(
                params[:, kk, :], position0, normal0, cameras.C[ref]
            )
            scores, _, _ = _allview_scores(
                images, cameras, pos, nrm, ref, vis, texture_size, plan=plan,
            )
            err = jnp.sum(
                jnp.where(payload, 1.0 - scores, 0.0), axis=1
            )
            costs.append(
                jnp.where(
                    n_payload > 0,
                    err / jnp.maximum(n_payload, 1),
                    2.0,
                )
            )
        return jnp.stack(costs, axis=1)

    return f


def _check_impl(impl: str):
    """One production scoring semantics: the all-views (B, V) grid. The
    chunked values are retired, loudly."""
    if impl not in ("auto", "paged"):
        raise ValueError(
            f"sampling_impl {impl!r} is retired: the all-views score grid "
            "(ops/allview.py) is the single production scoring semantics. "
            "The chunked implementation remains available as a parity "
            "reference (photometric_objective / _anchor_chunks, exercised "
            "by tests/ops/test_allview.py)."
        )


def _anchor_chunks(vis: jax.Array, max_views: int):
    """Split each patch's visible set into anchor-pinned slot chunks.

    PARITY REFERENCE ONLY — no production stage dispatches the chunked
    path; it survives for the all-views-vs-chunked equivalence
    tests (one independent derivation of optimization.cpp:98-132).

    Every chunk is (view_ids (B, M), ok (B, M)) with slot 0 = the patch's
    FIRST visible view (the anchor texture) and up to M-1 payload views in
    ascending view order. Together the chunks cover ALL visible views, so
    DTU-scale scenes (V ~ 50 > max_views) score every view instead of
    silently truncating at the compaction width.
    """
    B, V = vis.shape
    M = min(V, max_views)
    order = jnp.argsort(~vis, axis=1, stable=True)  # visible first
    okf = jnp.take_along_axis(vis, order, axis=1)
    payload = max(M - 1, 1)
    n_chunks = max(1, -(-(V - 1) // payload))
    chunks = []
    for c in range(n_chunks):
        lo = 1 + c * payload
        hi = min(lo + payload, V)
        ids = jnp.concatenate([order[:, :1], order[:, lo:hi]], axis=1)
        ok = jnp.concatenate([okf[:, :1], okf[:, lo:hi]], axis=1)
        if hi - lo < payload:  # pad the tail chunk to a stable width
            pad = payload - (hi - lo)
            ids = jnp.concatenate(
                [ids, jnp.broadcast_to(order[:, :1], (B, pad))], axis=1
            )
            ok = jnp.concatenate([ok, jnp.zeros((B, pad), bool)], axis=1)
        chunks.append((ids.astype(jnp.int32), ok))
    return chunks


def _sliced(fn_jit, images, cameras, state, texture_size, config):
    """Run a jitted per-patch stage over `max_refine_batch` slices.

    The slicing lives OUTSIDE jit on purpose: inside one XLA program the
    scheduler may keep independent slices' buffers live simultaneously,
    which defeats the point of bounding the per-dispatch working set.
    Host dispatch per slice is negligible at these batch sizes. Slices are
    padded to one fixed shape so every dispatch hits the same compiled
    program.
    """
    B = state.capacity
    mb = config.max_refine_batch
    if mb <= 0 or B <= mb:
        if jax.default_backend() != "cpu" and B:
            # Bucket the dispatch shape (pow2, capped at the slice width):
            # raw capacities vary run to run (seed survival, accepted
            # counts), and every fresh shape is a fresh compile. Padded
            # lanes are zeroed (no visibility -> no scored slots, instant
            # NM convergence) and trimmed from the result.
            target = 256
            while target < B:
                target *= 2
            if mb > 0:
                target = min(target, mb)
            if target != B:
                padded = jax.tree.map(
                    lambda a: jnp.concatenate(
                        [a, jnp.zeros((target - B,) + a.shape[1:], a.dtype)],
                        axis=0,
                    ),
                    state,
                )
                out = fn_jit(images, cameras, padded, texture_size, config)
                return jax.tree.map(lambda a: a[:B], out)
        return fn_jit(images, cameras, state, texture_size, config)
    outs = []
    for lo in range(0, B, mb):
        sl = jax.tree.map(lambda a: a[lo : lo + mb], state)
        pad = mb - sl.capacity
        if pad:
            sl = jax.tree.map(
                lambda a: jnp.concatenate(
                    [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
                ),
                sl,
            )
        out = fn_jit(images, cameras, sl, texture_size, config)
        # Serialize slices: async dispatch would hold every slice's
        # execution workspace live at once, which is the point of slicing
        # to avoid. The host sync costs microseconds against
        # milliseconds-to-seconds of per-slice compute.
        jax.block_until_ready(out.position)
        outs.append(out)
    full = jax.tree.map(lambda *ls: jnp.concatenate(ls, axis=0), *outs)
    return jax.tree.map(lambda a: a[:B], full)


def filter_by_error(
    images: jax.Array,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    config: OptimizeConfig = OptimizeConfig(),
) -> PatchState:
    """NCC visibility pruning + patch rejection (optimization.cpp:98-132).

    Processes at most `config.max_refine_batch` patches per dispatch (see
    `_sliced`).
    """
    return _sliced(
        _filter_by_error_jit, images, cameras, state, texture_size, config
    )


@functools.partial(jax.jit, static_argnames=("texture_size", "config"))
def _filter_by_error_jit(
    images: jax.Array,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    config: OptimizeConfig = OptimizeConfig(),
) -> PatchState:
    """NCC visibility pruning + patch rejection (optimization.cpp:98-132).

    The reference scores EVERY visible view (optimization.cpp:98-132); ONE
    all-views pass on the (B, V) score grid — the Triton kernel on CUDA,
    `allview_scores_xla` elsewhere. This is the SINGLE production scoring
    semantics: the anchor-pinned chunked path survives only as a parity
    reference in the tests. Semantics identical to the chunked path: the
    anchor slot (first visible view) is always kept when the patch has any
    visibility, payload views survive at `score_threshold`, a patch dies
    with no scorable views or fewer than `min_visible_views` remaining.
    """
    _check_impl(config.sampling_impl)
    B, V = state.vis.shape
    scores, anchor, _ = _allview_scores(
        images, cameras, state.position, state.normal, state.ref,
        state.vis, texture_size,
    )
    cols = jax.lax.broadcasted_iota(jnp.int32, (B, V), 1)
    has = jnp.any(state.vis, axis=1)
    payload = state.vis & (cols != anchor[:, None])
    anchor_slot = (cols == anchor[:, None]) & has[:, None]
    new_vis = anchor_slot | (payload & (scores >= config.score_threshold))
    n_scorable = jnp.sum(payload, axis=1)
    n_after = jnp.sum(new_vis, axis=1)
    alive = (
        state.alive
        & (n_scorable > 0)
        & (n_after >= config.min_visible_views)
    )
    return dataclasses.replace(state, vis=new_vis, alive=alive)


def optimize_patches(
    images: jax.Array,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    config: OptimizeConfig = OptimizeConfig(),
) -> PatchState:
    """Batched (depth, roll, pitch) refinement of every patch.

    Processes at most `config.max_refine_batch` patches per dispatch (see
    `_sliced`). NOTE: slicing changes the batch each NM global-early-exit
    couples over, so results can differ (both validly converged) from an
    unsliced run at different `max_refine_batch`.
    """
    return _sliced(
        _optimize_patches_jit, images, cameras, state, texture_size, config
    )


@functools.partial(jax.jit, static_argnames=("texture_size", "config"))
def _optimize_patches_jit(
    images: jax.Array,
    cameras: Cameras,
    state: PatchState,
    texture_size: int,
    config: OptimizeConfig = OptimizeConfig(),
) -> PatchState:
    """Batched (depth, roll, pitch) refinement of every patch.

    Mirrors `OptimizationOpenCV::Optimize` (always "succeeds"; positions and
    normals are overwritten with the minimizer result — dead patches keep
    their pose).
    """
    _check_impl(config.sampling_impl)
    f = photometric_objective_allviews(
        images,
        cameras,
        state.position,
        state.normal,
        state.ref,
        state.vis,
        texture_size,
    )
    B = state.capacity
    x0 = jnp.zeros((B, 3), state.position.dtype)
    if config.depth_sweep_steps > 1:
        # Depth-sweep re-init (see OptimizeConfig.depth_sweep_steps): one
        # batched objective call over D candidate depths along the
        # reference ray; NM starts from the best instead of 0.
        D = config.depth_sweep_steps
        depths = jnp.linspace(
            -config.depth_sweep_span, config.depth_sweep_span, D
        ).astype(state.position.dtype)
        sweep = jnp.zeros((B, D, 3), state.position.dtype).at[:, :, 0].set(
            depths[None, :]
        )
        costs = f(sweep)  # (B, D)
        best = jnp.argmin(costs, axis=1)
        x0 = x0.at[:, 0].set(depths[best])
    init_step = jnp.asarray(
        [config.init_step_depth, config.init_step_angle, config.init_step_angle],
        state.position.dtype,
    )
    x_best, _, _ = nelder_mead(
        f,
        x0,
        init_step,
        max_iterations=config.max_iterations,
        tolerance=config.tolerance,
    )
    pos, nrm = unparametrize(
        x_best, state.position, state.normal, cameras.C[state.ref]
    )
    keep = state.alive[:, None]
    return dataclasses.replace(
        state,
        position=jnp.where(keep, pos, state.position),
        normal=jnp.where(keep, nrm, state.normal),
    )


# Unsliced single-dispatch stage functions, for callers that manage the
# `max_refine_batch` memory bound themselves (the multihost driver slices
# OUTSIDE its sharded jits — re-jitting the `_sliced` wrappers would unroll
# the slice loop into one XLA program and silently defeat the bound). Do NOT wrap `optimize_patches`/`filter_by_error` in
# another jax.jit for the same reason.
optimize_patches_once = _optimize_patches_jit
filter_by_error_once = _filter_by_error_jit
