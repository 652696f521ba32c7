"""All-views anchor NCC: the (B, V) score grid of every refinement step.

scores[b, v] is NCC(anchor texture, view-v texture) for every visible
non-anchor view v of patch b with a valid warp, else -1. The anchor is the
patch's FIRST visible view (textures[0] of optimization.cpp:98-132);
population statistics and the 0.1 denominator clamp follow
core/scores.py.

Two implementations with identical semantics:

  * `allview_scores_xla` samples every (patch, view, texel) through
    ops/warp.patch_textures and masks afterwards. It runs everywhere and
    is the reference.
  * `allview_scores_triton` is a Pallas kernel (`backend="triton"`) for
    CUDA GPUs. Visible (patch, view) slots are compacted in view-major
    order once per mask (`make_plan`), so consecutive programs read one
    image and work scales with sum(vis), not B * V. Each program takes
    `_slots_per_program` slots, folds the projection of the patch plane
    into three homogeneous 3-vectors per slot, computes the k*k texel
    coordinates from them in registers, gathers the four bilinear taps
    straight from the f32 image stack and centers the texture. A first
    pass writes the anchor textures and sigmas (B rows); the second pass
    scores every payload slot against its anchor and writes one float
    per slot. No (B, V, k*k) intermediate exists.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from densepoints.core.scores import NCC_MIN_DENOM
from densepoints.ops.warp import patch_frames, patch_textures

__all__ = [
    "ScorePlan",
    "make_plan",
    "allview_scores_triton",
    "allview_scores_xla",
]

_BLOCK_ELEMS = 2048  # texels per program (slots x padded texture lanes)
_CAM_STRIDE = 32  # floats per view row: R (9), K (9), C (3), width, height
_PLAN_QUANTUM = 128  # plan capacity granularity (a multiple of every SB)


def _lanes(texture_size: int) -> int:
    """k*k padded to a power of two (Triton block sizes are powers of 2)."""
    n = texture_size * texture_size
    return 1 << (n - 1).bit_length()


def _slots_per_program(texture_size: int) -> int:
    return min(_PLAN_QUANTUM, max(1, _BLOCK_ELEMS // _lanes(texture_size)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScorePlan:
    """Slot schedule for one visibility mask (B, V).

    anchor: (B,) int32 first visible view; has: (B,) any visibility.
    slots:  (Npad,) int32 view-major flat ids v * B + b of the payload
            (visible, non-anchor) slots, -1 past `count`.
    inv:    (V * B,) int32 position of each view-major (v, b) in `slots`
            (meaningful where `payload` is set).
    payload: (B, V) bool visible non-anchor views.
    count:  (1,) int32 number of payload slots.
    """

    anchor: jax.Array
    has: jax.Array
    slots: jax.Array
    inv: jax.Array
    payload: jax.Array
    count: jax.Array


def make_plan(vis: jax.Array) -> ScorePlan:
    """Compact the payload slots of `vis` (B, V) in view-major order.

    A function of the mask alone, so Nelder-Mead callers build it once
    outside the solver loop. Capacity is the static worst case B * V
    (rounded up to `_PLAN_QUANTUM`); programs past `count` exit at once.
    """
    B, V = vis.shape
    anchor = jnp.argmax(vis, axis=1).astype(jnp.int32)
    has = jnp.any(vis, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (B, V), 1)
    payload = vis & (cols != anchor[:, None])
    flat = payload.T.reshape(-1)  # view-major: v * B + b
    N = B * V
    npad = -(-N // _PLAN_QUANTUM) * _PLAN_QUANTUM
    (slots,) = jnp.nonzero(flat, size=npad, fill_value=-1)
    inv = jnp.cumsum(flat.astype(jnp.int32)) - 1
    count = jnp.sum(flat.astype(jnp.int32)).reshape(1)
    return ScorePlan(
        anchor=anchor,
        has=has,
        slots=slots.astype(jnp.int32),
        inv=inv.astype(jnp.int32),
        payload=payload,
        count=count,
    )


def _camera_table(cameras) -> jax.Array:
    """(V * _CAM_STRIDE,) f32 rows [R | K | C | width | height | 0...]."""
    V = cameras.P.shape[0]
    f32 = jnp.float32
    rows = jnp.concatenate(
        [
            cameras.E[:, :, :3].reshape(V, 9).astype(f32),
            cameras.K.reshape(V, 9).astype(f32),
            cameras.C.astype(f32),
            cameras.width.astype(f32)[:, None],
            cameras.height.astype(f32)[:, None],
            jnp.zeros((V, _CAM_STRIDE - 23), f32),
        ],
        axis=1,
    )
    return rows.reshape(-1)


def _slot_textures(img_ref, pat_ref, cam_ref, b, v, k, S, H, W):
    """Centered textures (SB, S), sigma (SB,) and validity (SB,) of slots.

    b, v: (SB,) int32 patch and view of each slot (always in range).
    Lanes >= k*k are zero in the centered texture.
    """
    f32 = jnp.float32

    def pat(c):
        return pat_ref[b * 9 + c]

    def cam(c):
        return cam_ref[v * _CAM_STRIDE + c]

    R = [cam(i) for i in range(9)]
    Kc = [cam(9 + i) for i in range(9)]
    C = [cam(18 + i) for i in range(3)]
    w = cam(21)
    h = cam(22)
    rel = [pat(i) - C[i] for i in range(3)]
    sx = [pat(3 + i) for i in range(3)]
    sy = [pat(6 + i) for i in range(3)]

    def project(p):  # K @ (R @ p), the decomposed form of Cameras.project
        c = [R[3 * i] * p[0] + R[3 * i + 1] * p[1] + R[3 * i + 2] * p[2]
             for i in range(3)]
        return [Kc[3 * i] * c[0] + Kc[3 * i + 1] * c[1] + Kc[3 * i + 2] * c[2]
                for i in range(3)]

    a0 = project(rel)
    ax = project(sx)
    ay = project(sy)

    # 4-corner strict-bounds validity (patch.cpp:132-135).
    valid = None
    for s, t in ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)):
        hx, hy, hz = (a0[i] + s * ax[i] + t * ay[i] for i in range(3))
        px = hx / hz
        py = hy / hz
        inside = (px > 0) & (px < w) & (py > 0) & (py < h)
        valid = inside if valid is None else valid & inside

    # Texel (row t, column s) of lane j = row * k + col, as patch_textures.
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, S), 1)
    row = lane // k
    col = lane - row * k
    ss = (2.0 * col.astype(f32)) / k - 1.0
    tt = (2.0 * row.astype(f32)) / k - 1.0
    hx, hy, hz = (
        a0[i][:, None] + ss * ax[i][:, None] + tt * ay[i][:, None]
        for i in range(3)
    )
    x = jnp.clip(hx / hz, 0.0, W - 1.0)
    y = jnp.clip(hy / hz, 0.0, H - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 2)
    dx = x - x0.astype(f32)
    dy = y - y0.astype(f32)
    base = v[:, None] * (H * W) + y0 * W + x0
    tex = (
        img_ref[base] * (1 - dx) * (1 - dy)
        + img_ref[base + 1] * dx * (1 - dy)
        + img_ref[base + W] * (1 - dx) * dy
        + img_ref[base + W + 1] * dx * dy
    )
    live = lane < k * k
    n = float(k * k)
    mean = jnp.sum(jnp.where(live, tex, 0.0), axis=1) / n
    ctex = jnp.where(live, tex - mean[:, None], 0.0)
    sig = jnp.sqrt(jnp.sum(ctex * ctex, axis=1) / n)
    return ctex, sig, valid


def _anchor_kernel(k, S, H, W, SB):
    def kernel(img_ref, pat_ref, cam_ref, anchor_ref, has_ref,
               ctex_ref, sig_ref):
        lo = pl.program_id(0) * SB
        b = lo + jax.lax.broadcasted_iota(jnp.int32, (SB,), 0)
        v = anchor_ref[pl.ds(lo, SB)]
        ctex, sig, valid = _slot_textures(
            img_ref, pat_ref, cam_ref, b, v, k, S, H, W
        )
        ok = valid & (has_ref[pl.ds(lo, SB)] != 0)
        ctex_ref[pl.ds(lo, SB), :] = ctex
        # Sigma -1 marks an invalid anchor (a real sigma is >= 0).
        sig_ref[pl.ds(lo, SB)] = jnp.where(ok, sig, -1.0)

    return kernel


def _payload_kernel(k, S, H, W, SB, B):
    def kernel(img_ref, pat_ref, cam_ref, slots_ref, count_ref,
               actex_ref, asig_ref, out_ref):
        lo = pl.program_id(0) * SB

        @pl.when(lo < count_ref[0])
        def _():
            sid = jnp.maximum(slots_ref[pl.ds(lo, SB)], 0)
            v = sid // B
            b = sid - v * B
            ctex, sig, valid = _slot_textures(
                img_ref, pat_ref, cam_ref, b, v, k, S, H, W
            )
            lane = jax.lax.broadcasted_iota(jnp.int32, (1, S), 1)
            actex = actex_ref[b[:, None] * S + lane]
            asig = asig_ref[b]
            n = float(k * k)
            cov = jnp.sum(ctex * actex, axis=1) / n
            den = jnp.maximum(asig * sig, NCC_MIN_DENOM)
            out_ref[pl.ds(lo, SB)] = jnp.where(
                valid & (asig >= 0.0), cov / den, -1.0
            )

    return kernel


_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=1)


@functools.partial(jax.jit, static_argnames=("texture_size", "interpret"))
def allview_scores_triton(
    images: jax.Array,
    cameras,
    position: jax.Array,
    normal: jax.Array,
    ref: jax.Array,
    vis: jax.Array,
    texture_size: int,
    plan: ScorePlan | None = None,
    interpret: bool = False,
):
    """(scores (B, V), anchor (B,), anchor_ok (B,)) via the Triton kernel.

    Same semantics as `allview_scores_xla`. `plan` (from `make_plan(vis)`)
    is a Nelder-Mead loop invariant: solver callers build it once.
    """
    B, V = vis.shape
    _, H, W = images.shape
    k = texture_size
    S = _lanes(k)
    SB = _slots_per_program(k)
    if plan is None:
        plan = make_plan(vis)
    sx, sy = patch_frames(cameras, position, normal, ref, k)
    f32 = jnp.float32
    bp = -(-B // SB) * SB
    pat = jnp.concatenate(
        [position.astype(f32), sx.astype(f32), sy.astype(f32)], axis=1
    )
    pat = jnp.pad(pat, ((0, bp - B), (0, 0))).reshape(-1)
    cam = _camera_table(cameras)
    img = images.astype(f32).reshape(-1)
    anchor = jnp.pad(plan.anchor, (0, bp - B))
    has = jnp.pad(plan.has.astype(jnp.int32), (0, bp - B))

    actex, asig = pl.pallas_call(
        _anchor_kernel(k, S, H, W, SB),
        out_shape=(
            jax.ShapeDtypeStruct((bp, S), f32),
            jax.ShapeDtypeStruct((bp,), f32),
        ),
        grid=(bp // SB,),
        backend="triton",
        compiler_params=_PARAMS,
        interpret=interpret,
        name="allview_anchor",
    )(img, pat, cam, anchor, has)

    npad = plan.slots.shape[0]
    s = pl.pallas_call(
        _payload_kernel(k, S, H, W, SB, B),
        out_shape=jax.ShapeDtypeStruct((npad,), f32),
        grid=(npad // SB,),
        backend="triton",
        compiler_params=_PARAMS,
        interpret=interpret,
        name="allview_payload",
    )(img, pat, cam, plan.slots, plan.count, actex.reshape(-1), asig)

    flat = plan.payload.T.reshape(-1)
    vm = jnp.where(flat, s[jnp.clip(plan.inv, 0, npad - 1)], -1.0)
    scores = vm.reshape(V, B).T
    aok = (asig[:B] >= 0.0) & plan.has
    return scores, plan.anchor, aok


def allview_scores_xla(
    images: jax.Array,
    cameras,
    position: jax.Array,
    normal: jax.Array,
    ref: jax.Array,
    vis: jax.Array,
    texture_size: int,
):
    """Plain-XLA reference: sample all (B, V, k*k) texels, then mask."""
    B, V = vis.shape
    k = texture_size
    n = float(k * k)
    tex, valid = patch_textures(
        images, cameras, position, normal, ref, vis, k
    )  # (B, V, k, k), valid = corner-valid & vis
    flat = tex.reshape(B, V, k * k).astype(jnp.float32)
    anchor = jnp.argmax(vis, axis=1).astype(jnp.int32)
    has = jnp.any(vis, axis=1)
    bidx = jnp.arange(B)
    aflat = flat[bidx, anchor]  # (B, k*k)
    aok = valid[bidx, anchor] & has
    am = jnp.mean(aflat, axis=1, keepdims=True)
    cam_ = aflat - am
    sa = jnp.sqrt(jnp.sum(cam_ * cam_, axis=1) / n)
    m = jnp.mean(flat, axis=2, keepdims=True)
    ct = flat - m
    st = jnp.sqrt(jnp.sum(ct * ct, axis=2) / n)
    cov = jnp.sum(ct * cam_[:, None, :], axis=2) / n
    den = jnp.maximum(sa[:, None] * st, NCC_MIN_DENOM)
    cols = jax.lax.broadcasted_iota(jnp.int32, (B, V), 1)
    payload = vis & (cols != anchor[:, None])
    scores = jnp.where(
        payload & valid & aok[:, None], cov / den, -1.0
    )
    return scores, anchor, aok
