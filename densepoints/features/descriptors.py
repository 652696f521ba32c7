"""Binary keypoint descriptors, sampled for matmul-based matching.

Reference parity: `Matcher::ComputeDescriptors` (matcher.cpp:155-183, OpenCV
ORB/AKAZE binary descriptors). Batched redesign: BRIEF-style descriptors — a
fixed seeded pattern of point-pair intensity comparisons on the blurred
image, gathered for ALL keypoints of all views in one op. The descriptor is
kept as a +-1 float matrix (B, D) so that Hamming distances become ONE
bf16 matmul: hamming(a, b) = (D - a.b) / 2 (see features/matching.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from densepoints.features.detector import gaussian_blur
from densepoints.ops.warp import bilinear_sample

__all__ = ["brief_pattern", "compute_descriptors"]


def brief_pattern(
    bits: int = 256, patch_radius: int = 15, seed: int = 7
) -> np.ndarray:
    """Fixed comparison pattern: (bits, 2, 2) offsets (pair of (dx, dy)).

    Gaussian-distributed offsets (sigma = radius/2) as in the BRIEF paper,
    clipped to the patch, generated once from a fixed seed (deterministic
    across hosts/devices).
    """
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, patch_radius / 2.0, size=(bits, 2, 2))
    return np.clip(pts, -patch_radius, patch_radius).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("blur_sigma",))
def compute_descriptors(
    images: jax.Array,
    xy: jax.Array,
    pattern: jax.Array,
    blur_sigma: float = 2.0,
):
    """+-1 descriptors for all keypoints of all views.

    images: (V, H, W); xy: (V, N, 2); pattern: (D, 2, 2).
    Returns (V, N, D) float32 in {-1, +1}.
    """
    blurred = gaussian_blur(images.astype(jnp.float32), blur_sigma)
    # Sample positions: keypoint + each pattern endpoint -> (V, N, D, 2, 2)
    pos = xy[:, :, None, None, :] + pattern[None, None, :, :, :]
    a = jax.vmap(bilinear_sample)(blurred, pos[..., 0, :])  # (V, N, D)
    b = jax.vmap(bilinear_sample)(blurred, pos[..., 1, :])
    return jnp.where(a > b, 1.0, -1.0).astype(jnp.float32)
