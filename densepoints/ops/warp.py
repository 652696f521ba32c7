"""Patch texture extraction: batched projective warp + bilinear sampling.

Reference parity: `Optimization::GetProjectedTextures`
(methods/pmvs/optimization.cpp:14-56) + `Patch::ComputePatchToViewHomography`
(patch.cpp:111-164) + `Patch::GetProjectedXYAxisAndScale` (patch.cpp:76-104).

The reference computes, per patch and per visible view, an OpenCV homography
from the 4 projected patch corners to a k x k square and calls
cv::warpPerspective (INTER_LINEAR + BORDER_REPLICATE). Batched redesign:
the patch is a textured plane, so the square->image map is composed
analytically — texel (u, v) lies at world point

    X(u, v) = p + (2u/k - 1) * s * x_axis + (2v/k - 1) * s * y_axis

which is projected and bilinearly sampled (clamp-to-edge == BORDER_REPLICATE
against the full image) for ALL patches x views x texels in one fused op.
No per-patch homography solve exists at all.

Semantics pinned by the reference:
  * x_axis = normalized camera x-axis of the REFERENCE view; y = n x x_axis
    (NOT normalized, patch.cpp:96-97).
  * dx = pixel length of one world x_axis unit at the patch in the reference
    view; world half-extent scale = (k // 2) / dx (integer division,
    optimization.cpp:31 with size_t cell_size).
  * a view's texture is invalid if ANY of the 4 corners projects outside
    that view (strict bounds), patch.cpp:132-135.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from densepoints.core.cameras import Cameras

__all__ = [
    "bilinear_sample",
    "patch_frames",
    "patch_textures",
    "patch_textures_indexed",
]


def bilinear_sample(image: jax.Array, xy: jax.Array) -> jax.Array:
    """Bilinear sample with clamp-to-edge. image: (H, W); xy: (..., 2)."""
    H, W = image.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.0)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 2) if W > 1 else jnp.zeros_like(x, jnp.int32)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 2) if H > 1 else jnp.zeros_like(y, jnp.int32)
    dx = x - x0
    dy = y - y0
    i00 = image[y0, x0]
    i01 = image[y0, x0 + 1]
    i10 = image[y0 + 1, x0]
    i11 = image[y0 + 1, x0 + 1]
    return (
        i00 * (1 - dx) * (1 - dy)
        + i01 * dx * (1 - dy)
        + i10 * (1 - dx) * dy
        + i11 * dx * dy
    )


def patch_frames(
    cameras: Cameras,
    position: jax.Array,
    normal: jax.Array,
    ref: jax.Array,
    texture_size: int,
):
    """Per-patch world-space tangent frame scaled to span the texture.

    position, normal: (B, 3); ref: (B,) int32 -> (sx, sy): (B, 3) world-space
    half-texel-grid axes such that the patch spans texture_size//2 px in the
    reference view along x.
    """
    x_axis = cameras.x_axis[ref]  # (B, 3), unit
    y_axis = jnp.cross(normal, x_axis)  # parity: NOT normalized
    K, E, C = cameras.K[ref], cameras.E[ref], cameras.C[ref]

    def _proj(pts):
        hi = jax.lax.Precision.HIGHEST  # pixel coords: never bf16
        cam = jnp.einsum("bij,bj->bi", E[:, :, :3], pts - C, precision=hi)
        pix = jnp.einsum("bij,bj->bi", K, cam, precision=hi)
        return pix[:, :2] / pix[:, 2:3]

    p0 = _proj(position)
    p1 = _proj(position + x_axis)
    dx = jnp.linalg.norm(p1 - p0, axis=-1)  # px per world unit
    scale = (texture_size // 2) / jnp.maximum(dx, 1e-12)
    return scale[:, None] * x_axis, scale[:, None] * y_axis


def patch_textures(
    images: jax.Array,
    cameras: Cameras,
    position: jax.Array,
    normal: jax.Array,
    ref: jax.Array,
    view_mask: jax.Array,
    texture_size: int,
):
    """Extract k x k textures of every patch in every (masked) view.

    images: (V, H, W) grayscale float; position/normal: (B, 3); ref: (B,);
    view_mask: (B, V) which views to extract (invalid -> valid=False).
    Returns (textures (B, V, k, k), valid (B, V)).
    """
    k = texture_size
    B = position.shape[0]
    V = images.shape[0]
    sx, sy = patch_frames(cameras, position, normal, ref, k)

    # Texel grid in plane coords: s,t in {2u/k - 1 : u = 0..k-1}.
    coords = (2.0 * jnp.arange(k, dtype=position.dtype) / k) - 1.0
    tt, ss = jnp.meshgrid(coords, coords, indexing="ij")  # (k, k): tt=v rows
    # World sample points: (B, k, k, 3)
    world = (
        position[:, None, None, :]
        + ss[None, :, :, None] * sx[:, None, None, :]
        + tt[None, :, :, None] * sy[:, None, None, :]
    )
    # Corners for validity: (B, 4, 3)
    corners = (
        position[:, None, :]
        + jnp.stack([-sx - sy, sx - sy, sx + sy, -sx + sy], axis=1)
    )

    # Project into all views: (V, B, k, k, 2) and (V, B, 4, 2)
    pix_world = cameras.project(world)
    pix_corners = cameras.project(corners)

    w = cameras.width.astype(position.dtype)[:, None, None]
    h = cameras.height.astype(position.dtype)[:, None, None]
    inside = (
        (pix_corners[..., 0] > 0)
        & (pix_corners[..., 0] < w)
        & (pix_corners[..., 1] > 0)
        & (pix_corners[..., 1] < h)
    )  # (V, B, 4)
    valid = jnp.all(inside, axis=-1).T & view_mask  # (B, V)

    # Sample per view: images (V,H,W) x pix (V,B,k,k,2).
    tex = jax.vmap(bilinear_sample)(images, pix_world)  # (V, B, k, k)
    textures = jnp.moveaxis(tex, 0, 1)  # (B, V, k, k)
    textures = jnp.where(valid[:, :, None, None], textures, 0.0)
    return textures, valid


def compact_visible(vis: jax.Array, max_views: int):
    """Compact each patch's visible-view set into M slots.

    vis: (B, V) -> (view_ids (B, M) int32, ok (B, M) bool). Slot 0 is the
    FIRST visible view (the reference's anchor, textures[0]); slots are in
    ascending view order; ok marks real (visible) slots.
    """
    M = min(vis.shape[1], max_views)
    order = jnp.argsort(~vis, axis=1, stable=True)[:, :M]
    ok = jnp.take_along_axis(vis, order, axis=1)
    return order.astype(jnp.int32), ok


def _bilinear_flat(images_flat, H, W, view_ids, xy):
    """Bilinear sample per-element view selection.

    images_flat: (V*H*W,); view_ids: (...,) int32; xy: (..., 2).
    Clamp-to-edge within each view's H x W page.
    """
    x = jnp.clip(xy[..., 0], 0.0, W - 1.0)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 2)
    dx = x - x0
    dy = y - y0
    base = view_ids * (H * W) + y0 * W + x0
    i00 = images_flat[base]
    i01 = images_flat[base + 1]
    i10 = images_flat[base + W]
    i11 = images_flat[base + W + 1]
    return (
        i00 * (1 - dx) * (1 - dy)
        + i01 * dx * (1 - dy)
        + i10 * (1 - dx) * dy
        + i11 * dx * dy
    )


def patch_textures_indexed(
    images: jax.Array,
    cameras: Cameras,
    position: jax.Array,
    normal: jax.Array,
    ref: jax.Array,
    view_ids: jax.Array,
    view_ok: jax.Array,
    texture_size: int,
):
    """Textures of each patch in its OWN (compacted) view list.

    Unlike `patch_textures`, which evaluates every patch against all V
    views, this gathers per-patch camera parameters for `view_ids` (B, M)
    — the patch's visible views padded to M — so work scales with actual
    visibility (M ~ 16) instead of scene size (V can be 50+ on DTU).
    The scaling redesign SURVEY.md §7 step 10 calls for.

    images: (V, H, W); view_ids: (B, M) int32; view_ok: (B, M) bool.
    Returns (textures (B, M, k, k), valid (B, M)).
    """
    k = texture_size
    V, H, W = images.shape
    sx, sy = patch_frames(cameras, position, normal, ref, k)

    coords = (2.0 * jnp.arange(k, dtype=position.dtype) / k) - 1.0
    tt, ss = jnp.meshgrid(coords, coords, indexing="ij")
    world = (
        position[:, None, None, :]
        + ss[None, :, :, None] * sx[:, None, None, :]
        + tt[None, :, :, None] * sy[:, None, None, :]
    )  # (B, k, k, 3)
    corners = (
        position[:, None, :]
        + jnp.stack([-sx - sy, sx - sy, sx + sy, -sx + sy], axis=1)
    )  # (B, 4, 3)

    # Gather per-(patch, view-slot) camera params.
    K = cameras.K[view_ids]  # (B, M, 3, 3)
    E = cameras.E[view_ids]
    C = cameras.C[view_ids]
    w = cameras.width.astype(position.dtype)[view_ids]  # (B, M)
    h = cameras.height.astype(position.dtype)[view_ids]

    def _proj(pts):  # pts: (B, n, 3) -> (B, M, n, 2)
        rel = pts[:, None, :, :] - C[:, :, None, :]
        hi = jax.lax.Precision.HIGHEST  # pixel coords: never bf16
        cam = jnp.einsum("bmij,bmnj->bmni", E[..., :3], rel, precision=hi)
        pix = jnp.einsum("bmij,bmnj->bmni", K, cam, precision=hi)
        return pix[..., :2] / pix[..., 2:3]

    pix_corners = _proj(corners)  # (B, M, 4, 2)
    inside = (
        (pix_corners[..., 0] > 0)
        & (pix_corners[..., 0] < w[..., None])
        & (pix_corners[..., 1] > 0)
        & (pix_corners[..., 1] < h[..., None])
    )
    valid = jnp.all(inside, axis=-1) & view_ok  # (B, M)

    pix_world = _proj(world.reshape(world.shape[0], k * k, 3))  # (B, M, k*k, 2)
    tex = _bilinear_flat(
        images.reshape(-1),
        H,
        W,
        view_ids[:, :, None],
        pix_world,
    )  # (B, M, k*k)
    textures = tex.reshape(tex.shape[0], tex.shape[1], k, k)
    textures = jnp.where(valid[:, :, None, None], textures, 0.0)
    return textures, valid
