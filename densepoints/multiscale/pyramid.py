"""Image pyramids + coarse-to-fine densification.

North-star addition: the reference's `Options::scale_` (options.h:11) hints
at multi-scale but is dead code. Here: a Gaussian-ish 2x2-average pyramid
with consistently scaled cameras (P' = diag(s, s, 1) P halves focal lengths
and principal points, preserving the projective geometry exactly), and a
coarse-to-fine driver — seed/expand at the coarsest level, then at each
finer level re-optimize + re-filter the carried-over patches and expand
further with the finer occupancy grid.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from densepoints.config import PipelineConfig
from densepoints.core.cameras import Cameras

__all__ = ["downsample2", "build_pyramid", "scale_cameras", "densify_multiscale"]


def downsample2(images: jax.Array) -> jax.Array:
    """2x2 average-pool downsample of (..., H, W) (H, W even-truncated)."""
    H, W = images.shape[-2:]
    H2, W2 = H // 2, W // 2
    x = images[..., : H2 * 2, : W2 * 2]
    x = x.reshape(x.shape[:-2] + (H2, 2, W2, 2))
    return x.mean(axis=(-3, -1))


def scale_cameras(cameras: Cameras, scale: float) -> Cameras:
    """Cameras for images resized by `scale` (e.g. 0.5 per pyramid level)."""
    S = np.diag([scale, scale, 1.0])
    P = S @ np.asarray(cameras.P, np.float64)
    return Cameras.from_projection_matrices(
        P,
        widths=np.maximum(
            (np.asarray(cameras.width) * scale).astype(np.int32), 1
        ),
        heights=np.maximum(
            (np.asarray(cameras.height) * scale).astype(np.int32), 1
        ),
    )


def build_pyramid(images: jax.Array, cameras: Cameras, levels: int):
    """[(images, cameras)] from finest (level 0) to coarsest."""
    out = [(images, cameras)]
    for lvl in range(1, levels):
        images = downsample2(images)
        out.append((images, scale_cameras(cameras, 0.5**lvl)))
    return out


def densify_multiscale(
    scene_images: jax.Array,
    cameras: Cameras,
    seeds,
    config: PipelineConfig,
):
    """Coarse-to-fine expansion. `seeds` is a PatchState at full-resolution
    geometry (world space is scale-invariant; only textures change).

    Returns the final PatchState (world-space, finest level).
    """
    from densepoints.pmvs.expand import expand_patches
    from densepoints.pmvs.filter import run_filters
    from densepoints.pmvs.optimize import filter_by_error, optimize_patches
    from densepoints.utils import log

    levels = max(1, config.multiscale.levels)
    pyramid = build_pyramid(scene_images, cameras, levels)

    state = seeds
    for lvl in range(levels - 1, -1, -1):
        images_l, cams_l = pyramid[lvl]
        log.info(
            "multiscale level %d: %dx%d, %d patches in",
            lvl,
            int(cams_l.width[0]),
            int(cams_l.height[0]),
            state.capacity,
        )
        if lvl != levels - 1:
            # Carried-over patches: refine against the finer textures.
            state = optimize_patches(
                images_l, cams_l, state, config.seed.texture_size, config.optimize
            )
            state = filter_by_error(
                images_l, cams_l, state, config.seed.texture_size, config.optimize
            )
            state = state.compact()
        state, _ = expand_patches(
            images_l,
            cams_l,
            state,
            config.expand,
            config.organizer,
            config.optimize,
        )
        state = run_filters(
            cams_l,
            state,
            config.filter,
            config.optimize,
            config.organizer.grid_scale,
        )
        state = state.compact()
    return state
