"""Batched plane-induced homographies and 4-point DLT.

Reference parity: `methods/pmvs/patch.cpp:111-164` builds, per patch and view,
a homography from the 4 projected patch corners to a k x k square via
`cv::findHomography(.., 0)` (exact DLT on 4 correspondences). Here we skip
the generic DLT entirely on the hot path: a patch is a textured plane, so the
square -> image map is composed analytically (patch-plane point -> world ->
projection), which `ops/warp.py` evaluates directly per texel. The 4-point DLT
here exists for API parity and for tests that need an explicit 3x3 H.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["homography_from_4pts", "apply_homography", "plane_homography"]


def _normalization_transform(pts: jax.Array):
    """Hartley similarity normalization: zero mean, sqrt(2) RMS radius.

    pts: (..., N, 2) -> (T (..., 3, 3), normalized pts). Keeps the DLT
    normal matrix well conditioned in f32.
    """
    mean = jnp.mean(pts, axis=-2, keepdims=True)
    centered = pts - mean
    rms = jnp.sqrt(jnp.mean(jnp.sum(centered**2, axis=-1), axis=-1))
    scale = jnp.sqrt(2.0) / jnp.maximum(rms, 1e-12)
    normed = centered * scale[..., None, None]
    s = scale[..., None]
    zero = jnp.zeros_like(s)
    one = jnp.ones_like(s)
    T = jnp.stack(
        [
            jnp.concatenate([s, zero, -s * mean[..., 0, 0:1]], axis=-1),
            jnp.concatenate([zero, s, -s * mean[..., 0, 1:2]], axis=-1),
            jnp.concatenate([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    return T, normed


def homography_from_4pts(src: jax.Array, dst: jax.Array) -> jax.Array:
    """Exact homography mapping 4 src points to 4 dst points (batched).

    src, dst: (..., 4, 2). Hartley-normalized DLT on the 8x9 system, solved
    via the smallest eigenvector of the 9x9 normal matrix (f32-safe).
    """
    T_src, src_n = _normalization_transform(src)
    T_dst, dst_n = _normalization_transform(dst)
    Hn = _homography_dlt_raw(src_n, dst_n)
    # H = T_dst^-1 @ Hn @ T_src
    H = jnp.einsum(
        "...ij,...jk,...kl->...il", jnp.linalg.inv(T_dst), Hn, T_src
    )
    return H / H[..., 2:3, 2:3]


def _homography_dlt_raw(src: jax.Array, dst: jax.Array) -> jax.Array:
    x, y = src[..., 0], src[..., 1]  # (..., 4)
    u, v = dst[..., 0], dst[..., 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    row_u = jnp.stack(
        [x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u], axis=-1
    )  # (..., 4, 9)
    row_v = jnp.stack(
        [zeros, zeros, zeros, x, y, ones, -v * x, -v * y, -v], axis=-1
    )
    A = jnp.concatenate([row_u, row_v], axis=-2)  # (..., 8, 9)
    AtA = jnp.einsum("...ri,...rj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    h = vecs[..., 0]
    return h.reshape(h.shape[:-1] + (3, 3))


def apply_homography(H: jax.Array, pts: jax.Array) -> jax.Array:
    """H: (..., 3, 3); pts: (..., N, 2) -> (..., N, 2)."""
    ph = jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)
    out = jnp.einsum(
        "...ij,...nj->...ni", H, ph,
        precision=jax.lax.Precision.HIGHEST,  # pixel coords: never bf16
    )
    return out[..., :2] / out[..., 2:3]


def plane_homography(
    P: jax.Array, origin: jax.Array, ex: jax.Array, ey: jax.Array
) -> jax.Array:
    """Analytic homography from plane coords (s, t) to image pixels.

    The plane point is origin + s * ex + t * ey; the image of (s, t, 1) under
    P is then P @ [ex | ey | origin] as a 3x3 homography. Batched over any
    leading dims of (P, origin, ex, ey).
    """
    M = jnp.stack([ex, ey, origin], axis=-1)  # (..., 3, 3) columns
    A = jnp.einsum(
        "...ij,...jk->...ik", P[..., :, :3], M,
        precision=jax.lax.Precision.HIGHEST,  # pixel coords: never bf16
    )
    A = A.at[..., :, 2].add(P[..., :, 3])
    return A
