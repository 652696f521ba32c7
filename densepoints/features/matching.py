"""Keypoint matching: matmul Hamming kNN + ratio test, and epipolar paths.

Reference parity: `Matcher::MatchKeypoints` (matcher.cpp:206-265,
BruteForce-Hamming knnMatch k=2 + Lowe ratio 0.7), `Matcher::FilterMatches`
(matcher.cpp:319-372, drop matches > 1.5 px from the epipolar line) and
`Matcher::DirectEpipolarMatching` (matcher.cpp:267-317, accept every
keypoint pair near the epipolar line, no descriptors).

Batched redesign: descriptors are +-1 vectors, so the full N x M Hamming matrix
of one image pair is a single bf16 matmul
(hamming = (D - a.b)/2); the 2-NN + ratio test is a top-2 over that matrix;
the epipolar filter is a gather of precomputed line coefficients. All pairs
of a scene batch through vmap.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from densepoints.geometry.fundamental import (
    epipolar_lines,
    point_line_distance,
)

__all__ = [
    "hamming_distance_matrix",
    "match_pair",
    "match_pair_absolute",
    "direct_epipolar_pair",
    "direct_epipolar_pair_topk",
]


def hamming_distance_matrix(desc1: jax.Array, desc2: jax.Array) -> jax.Array:
    """(N, M) Hamming distances between +-1 descriptor sets.

    desc1: (N, D); desc2: (M, D). One matmul: (D - dot)/2.
    """
    D = desc1.shape[-1]
    dot = jax.lax.dot_general(
        desc1.astype(jnp.bfloat16),
        desc2.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        # Explicit DEFAULT: descriptors are +-1 (exact in bf16); the
        # package-wide "highest" matmul precision is for f32 GEOMETRY and
        # would only slow this down.
        precision=jax.lax.Precision.DEFAULT,
    )
    return 0.5 * (D - dot)


@functools.partial(jax.jit, static_argnames=())
def match_pair(
    desc1: jax.Array,
    desc2: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    lowe_ratio: float = 0.7,
):
    """kNN(2) + Lowe ratio matching of one view pair.

    Returns (match_idx (N,) int32 — index into view 2's keypoints or -1,
    distance (N,) float32). One-directional (query = view 1), like the
    reference's knnMatch.
    """
    ham = hamming_distance_matrix(desc1, desc2)  # (N, M)
    big = jnp.asarray(1e9, ham.dtype)
    ham = jnp.where(valid2[None, :], ham, big)
    neg_top2, idx_top2 = jax.lax.top_k(-ham, 2)
    d1, d2 = -neg_top2[:, 0], -neg_top2[:, 1]
    ok = valid1 & (d1 < lowe_ratio * d2) & (d2 < big)
    return jnp.where(ok, idx_top2[:, 0], -1).astype(jnp.int32), d1


@jax.jit
def match_pair_absolute(
    desc1: jax.Array,
    desc2: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    max_distance: float = 30.0,
):
    """Nearest-neighbor matching with an absolute Hamming-distance cutoff.

    Parity with the reference's FLANN/LSH path (matcher.cpp:227-240): the
    LSH index returns approximate nearest neighbors and matches with
    distance < 30 are kept. Here the exact 1-NN over the Hamming matrix
    plays the LSH role (strictly better recall at dense-matmul cost).
    Returns (match_idx (N,) int32 or -1, distance (N,) float32).
    """
    ham = hamming_distance_matrix(desc1, desc2)  # (N, M)
    big = jnp.asarray(1e9, ham.dtype)
    ham = jnp.where(valid2[None, :], ham, big)
    best = jnp.argmin(ham, axis=1)
    dbest = jnp.take_along_axis(ham, best[:, None], axis=1)[:, 0]
    ok = valid1 & (dbest < max_distance)
    return jnp.where(ok, best, -1).astype(jnp.int32), dbest


def filter_matches_epipolar(
    F: jax.Array,
    xy1: jax.Array,
    xy2: jax.Array,
    match_idx: jax.Array,
    max_distance: float = 1.5,
):
    """Drop matches whose partner lies too far from the epipolar line.

    F: (3, 3) for the pair (x2^T F x1 = 0); xy1: (N, 2); xy2: (M, 2);
    match_idx: (N,) into xy2 or -1. Returns filtered (N,) match_idx.
    """
    lines = epipolar_lines(F, xy1)  # (N, 3)
    partner = xy2[jnp.maximum(match_idx, 0)]
    dist = point_line_distance(lines, partner)
    ok = (match_idx >= 0) & (dist <= max_distance)
    return jnp.where(ok, match_idx, -1)


def direct_epipolar_pair(
    F: jax.Array,
    xy1: jax.Array,
    xy2: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    max_distance: float = 1.5,
):
    """Descriptor-free epipolar matching (matcher.cpp:267-317).

    The reference accepts EVERY pair within the threshold; here each left
    keypoint takes its closest-to-the-line right keypoint (the dominant
    surviving candidate after the NCC filter downstream), keeping the output
    a fixed-shape (N,) index array.
    """
    dist = point_line_distance(
        epipolar_lines(F, xy1)[:, None, :], xy2[None, :, :]
    )  # (N, M)
    big = jnp.asarray(1e9, dist.dtype)
    dist = jnp.where(valid2[None, :], dist, big)
    best = jnp.argmin(dist, axis=1)
    dbest = jnp.take_along_axis(dist, best[:, None], axis=1)[:, 0]
    ok = valid1 & (dbest <= max_distance)
    return jnp.where(ok, best, -1).astype(jnp.int32), dbest


def direct_epipolar_pair_topk(
    F: jax.Array,
    xy1: jax.Array,
    xy2: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    max_distance: float = 1.5,
    k: int = 4,
):
    """All-pairs direct epipolar matching, fixed-shape (matcher.cpp:267-317).

    The reference accepts EVERY keypoint pair within `max_distance` of the
    epipolar line; a fixed-shape equivalent keeps the k closest qualifying
    partners per left keypoint (k bounds the output shape; partners beyond
    k are the (k+1)-th-closest to the line and essentially duplicate seeds
    of the same surface point). Returns (match_idx (N, k) int32 or -1,
    distance (N, k) f32).
    """
    dist = point_line_distance(
        epipolar_lines(F, xy1)[:, None, :], xy2[None, :, :]
    )  # (N, M)
    big = jnp.asarray(1e9, dist.dtype)
    dist = jnp.where(valid2[None, :], dist, big)
    neg_top, idx = jax.lax.top_k(-dist, k)  # (N, k) closest partners
    d = -neg_top
    ok = valid1[:, None] & (d <= max_distance)
    return jnp.where(ok, idx, -1).astype(jnp.int32), d
