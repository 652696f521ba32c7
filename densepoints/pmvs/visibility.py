"""Visibility classification of patches against all views.

Reference parity: `Patch::InitRelatedImages` (patch.cpp:19-49): for every
non-reference view whose image contains the patch position, the angle between
the patch normal and the ray (position - view center) classifies the view:
angle < 0.78 rad (~45 deg) -> truly visible, < 1.04 rad (~60 deg) ->
candidate. Batched here over (patches x views) in one op.

Also hosts `compute_color` (`Patch::ComputeColor`, patch.cpp:51-73): average
color over all views containing the point, nearest-pixel sampling.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from densepoints.core.cameras import Cameras

__all__ = ["classify_views", "compute_color"]


def classify_views(
    cameras: Cameras,
    position: jax.Array,
    normal: jax.Array,
    ref: jax.Array,
    visible_angle: float = 0.78,
    candidate_angle: float = 1.04,
):
    """(vis, cand) boolean masks of shape (B, V).

    position, normal: (B, 3); ref: (B,) int32.
    """
    inside = cameras.points_inside(position).T  # (B, V)
    rays = position[:, None, :] - cameras.C[None, :, :]  # (B, V, 3)
    ray_norm = jnp.linalg.norm(rays, axis=-1)
    cosang = jnp.sum(normal[:, None, :] * rays, axis=-1) / jnp.maximum(
        ray_norm, 1e-12
    )
    angle = jnp.arccos(jnp.clip(cosang, -1.0, 1.0))
    not_ref = (
        jnp.arange(cameras.num_views)[None, :] != ref[:, None]
    )
    base = inside & not_ref
    vis = base & (angle < visible_angle)
    cand = base & (angle >= visible_angle) & (angle < candidate_angle)
    return vis, cand


def compute_color(
    cameras: Cameras, colors: jax.Array, position: jax.Array
) -> jax.Array:
    """Average RGB over all views containing each point.

    colors: (V, H, W, 3) uint8/float; position: (B, 3) -> (B, 3) float RGB.
    Nearest-pixel sampling (the reference truncates to int, patch.cpp:63-64).
    """
    pix = cameras.project(position)  # (V, B, 2)
    inside = cameras.points_inside(position)  # (V, B)
    H, W = colors.shape[1], colors.shape[2]
    x = jnp.clip(pix[..., 0].astype(jnp.int32), 0, W - 1)
    y = jnp.clip(pix[..., 1].astype(jnp.int32), 0, H - 1)

    def sample(img, xx, yy):
        return img[yy, xx]  # (B, 3)

    sampled = jax.vmap(sample)(colors.astype(jnp.float32), x, y)  # (V, B, 3)
    w = inside.astype(jnp.float32)[..., None]
    total = jnp.sum(sampled * w, axis=0)
    count = jnp.maximum(jnp.sum(w, axis=0), 1.0)
    return total / count
