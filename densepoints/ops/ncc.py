"""Batched masked NCC over texture pairs.

Given flattened texture pairs (N, L) it computes the reference's NCC —
population statistics, cov / max(sigma_a * sigma_b, 0.1) — for every row
(core/scores.py semantics). A masked row-wise NCC is a reduction that XLA
fuses on every backend, so no kernel is needed. Only the parity reference
`pmvs.optimize.patch_ncc_scores` calls it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from densepoints.core.scores import ncc_score

__all__ = ["ncc_pairs"]


def ncc_pairs(
    a: jax.Array, b: jax.Array, mask: jax.Array | None = None
) -> jax.Array:
    """(N, L) texture pairs -> (N,) f32 NCC scores (-1 for empty rows)."""
    return ncc_score(a, b, mask).astype(jnp.float32)
