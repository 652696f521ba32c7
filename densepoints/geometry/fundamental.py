"""Batched fundamental-matrix and epipolar-line geometry.

Reference parity: `modules/geometry/fundamental_matrix.cpp:6-60` (F from two
projection matrices per Hartley-Zisserman p.244; epipolar line of a point;
point-line distances). Redesigned for batched execution: everything is batched over view
pairs and keypoint sets; lines are (a, b, c) coefficient triples instead of
Eigen ParametrizedLine objects, and the distance is the standard
|ax + by + c| / sqrt(a^2 + b^2) evaluated for whole keypoint matrices at once.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "fundamental_from_projections",
    "fundamental_matrices_for_pairs",
    "epipolar_lines",
    "point_line_distance",
    "epipolar_distance_matrix",
]


def fundamental_from_projections(P1: np.ndarray, P2: np.ndarray) -> np.ndarray:
    """F such that x2^T F x1 = 0, from two 3x4 projection matrices.

    Host/f64 (runs once per pair per scene): C = nullspace(P1); e' = P2 C;
    P1^+ = pseudo-inverse; F = [e']_x P2 P1^+  (H-Z p.244, as in the
    reference fundamental_matrix.cpp:6-35 which uses an LU kernel + adjoint
    pseudo-inverse; numerics agree to roundoff).
    """
    P1 = np.asarray(P1, np.float64)
    P2 = np.asarray(P2, np.float64)
    _, _, vt = np.linalg.svd(P1)
    C = vt[-1]
    e_p = P2 @ C
    P1_pinv = np.linalg.pinv(P1)
    e_x = np.array(
        [
            [0.0, -e_p[2], e_p[1]],
            [e_p[2], 0.0, -e_p[0]],
            [-e_p[1], e_p[0], 0.0],
        ]
    )
    return e_x @ P2 @ P1_pinv


def fundamental_matrices_for_pairs(
    P_all: np.ndarray, pairs: np.ndarray
) -> np.ndarray:
    """(num_pairs, 3, 3) F matrices for (num_pairs, 2) view-index pairs."""
    P_all = np.asarray(P_all, np.float64)
    out = np.zeros((len(pairs), 3, 3))
    for i, (a, b) in enumerate(pairs):
        F = fundamental_from_projections(P_all[a], P_all[b])
        # Normalize scale for f32 downstream use.
        n = np.linalg.norm(F)
        out[i] = F / (n if n > 0 else 1.0)
    return out


def epipolar_lines(F: jax.Array, points: jax.Array) -> jax.Array:
    """Lines l' = F x in the second image for points x in the first.

    F: (..., 3, 3); points: (..., N, 2) -> (..., N, 3) as (a, b, c).
    """
    ph = jnp.concatenate([points, jnp.ones_like(points[..., :1])], axis=-1)
    return jnp.einsum("...ij,...nj->...ni", F, ph)


def point_line_distance(lines: jax.Array, points: jax.Array) -> jax.Array:
    """|ax + by + c| / sqrt(a^2 + b^2), batched.

    lines: (..., 3); points: (..., 2) (broadcastable) -> (...,).
    """
    a, b, c = lines[..., 0], lines[..., 1], lines[..., 2]
    num = jnp.abs(a * points[..., 0] + b * points[..., 1] + c)
    return num / jnp.maximum(jnp.sqrt(a * a + b * b), 1e-12)


def epipolar_distance_matrix(
    F: jax.Array, pts1: jax.Array, pts2: jax.Array
) -> jax.Array:
    """All-pairs point-to-epipolar-line distances.

    F: (3, 3); pts1: (N, 2); pts2: (M, 2) -> (N, M) where entry (i, j) is the
    distance of pts2[j] to the epipolar line of pts1[i]. This is the
    vectorized form of the reference's O(K^2) DirectEpipolarMatching loop
    (matcher.cpp:267-317).
    """
    lines = epipolar_lines(F, pts1)  # (N, 3)
    return point_line_distance(lines[:, None, :], pts2[None, :, :])
