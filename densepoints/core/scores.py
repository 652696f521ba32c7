"""Photometric patch scores (batched, mask-aware).

Reference parity: `modules/core/error_measurements.cpp:18-100`. The reference
computes scores one patch pair at a time with OpenCV; here every score is a
reduction over the trailing axis of arbitrarily-batched arrays so thousands of
patch pairs score in one fused XLA op (`ops/ncc.py` and the all-views
score grid in `ops/allview.py` follow these semantics).

Semantics pinned by the reference:
  * NCC = cov_pop(a, b) / max(sigma_a * sigma_b, 0.1) with population
    statistics (divide by N), i.e. sum((a-am)(b-bm)) / (N * clamp).
    Golden value: NCC(a3x3, b3x3) == 0.1005653 (test_error_functions.cpp:13).
  * NCCByChannel: per-channel sum((a-am)(b-bm)) / max(sa*sb, 1e-3), summed
    over 3 channels, divided by (N * 3)  (error_measurements.cpp:62-100).
  * SSD = mean((a-b)^2)  (error_measurements.cpp:18-34).
  * Empty input returns -1 in the reference; here `mask` with zero valid
    pixels yields the same sentinel.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array

__all__ = [
    "ncc_score",
    "ssd_score",
    "sad_score",
    "ncc_score_by_channel",
    "NCC_MIN_DENOM",
]

NCC_MIN_DENOM = 0.1
NCC_CHANNEL_MIN_DENOM = 1e-3
EMPTY_SCORE = -1.0


def _masked_moments(x: Array, mask, axis=-1):
    if mask is None:
        n = x.shape[axis]
        mean = jnp.mean(x, axis=axis)
        return mean, jnp.asarray(float(n), x.dtype), None
    mask = mask.astype(x.dtype)
    n = jnp.sum(mask, axis=axis)
    n_safe = jnp.maximum(n, 1.0)
    mean = jnp.sum(x * mask, axis=axis) / n_safe
    return mean, n_safe, mask


def ncc_score(a: Array, b: Array, mask: Array | None = None) -> Array:
    """Normalized cross-correlation over the trailing axis.

    a, b: (..., N) flattened patches; mask: optional (..., N) validity.
    Returns (...,) scores in [-inf, 1]; 1.0 for a == a (up to clamp).
    """
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    am, n, m = _masked_moments(a, mask)
    bm, _, _ = _masked_moments(b, mask)
    ca = a - am[..., None]
    cb = b - bm[..., None]
    if m is not None:
        ca = ca * m
        cb = cb * m
    cov = jnp.sum(ca * cb, axis=-1) / n
    var_a = jnp.sum(ca * ca, axis=-1) / n
    var_b = jnp.sum(cb * cb, axis=-1) / n
    denom = jnp.maximum(jnp.sqrt(var_a) * jnp.sqrt(var_b), NCC_MIN_DENOM)
    score = cov / denom
    if mask is not None:
        score = jnp.where(
            jnp.sum(mask, axis=-1) > 0, score, jnp.asarray(EMPTY_SCORE, score.dtype)
        )
    return score


def ssd_score(a: Array, b: Array, mask: Array | None = None) -> Array:
    """Mean squared difference over the trailing axis."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    d2 = (a - b) ** 2
    if mask is None:
        return jnp.mean(d2, axis=-1)
    m = mask.astype(a.dtype)
    n = jnp.sum(m, axis=-1)
    score = jnp.sum(d2 * m, axis=-1) / jnp.maximum(n, 1.0)
    return jnp.where(n > 0, score, jnp.asarray(EMPTY_SCORE, score.dtype))


def sad_score(a: Array, b: Array, mask: Array | None = None) -> Array:
    """Mean absolute difference over the trailing axis.

    The reference declares SAD in the `ErrorMeasurement` enum
    (methods/pmvs/patch.h:93) but never implements it; provided here so the
    enum is fully usable.
    """
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    d = jnp.abs(a - b)
    if mask is None:
        return jnp.mean(d, axis=-1)
    m = mask.astype(a.dtype)
    n = jnp.sum(m, axis=-1)
    score = jnp.sum(d * m, axis=-1) / jnp.maximum(n, 1.0)
    return jnp.where(n > 0, score, jnp.asarray(EMPTY_SCORE, score.dtype))


def ncc_score_by_channel(a: Array, b: Array, mask: Array | None = None) -> Array:
    """Per-RGB-channel NCC, averaged.

    a, b: (..., N, 3); returns (...,). Matches the reference's
    sum_c [ sum((a_c-am_c)(b_c-bm_c)) / max(sa_c*sb_c, 1e-3) ] / (N*3).
    """
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    ac = jnp.moveaxis(a, -1, 0)  # (3, ..., N)
    bc = jnp.moveaxis(b, -1, 0)
    am, n, m = _masked_moments(ac, None if mask is None else mask[None])
    bm, _, _ = _masked_moments(bc, None if mask is None else mask[None])
    ca = ac - am[..., None]
    cb = bc - bm[..., None]
    if m is not None:
        ca = ca * m
        cb = cb * m
    num = jnp.sum(ca * cb, axis=-1)  # (3, ...)
    sa = jnp.sqrt(jnp.sum(ca * ca, axis=-1) / n)
    sb = jnp.sqrt(jnp.sum(cb * cb, axis=-1) / n)
    denom = jnp.maximum(sa * sb, NCC_CHANNEL_MIN_DENOM)
    total = jnp.sum(num / denom, axis=0)
    return total / (n[0] if m is not None else float(a.shape[-2])) / 3.0
