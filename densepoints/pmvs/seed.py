"""Seed generation: detector -> matcher -> tracks -> triangulation -> patches.

Reference parity: `Matcher::GenerateSeeds` (matcher.cpp:18-43) +
`Seed::ConvertSeedsToPatches` / `CreatePatchesFromPoints` (seed.cpp:20-86):
reference view = nearest camera center, normal = unit(point - C_ref),
then visibility classification, NCC filter, and simplex optimization.

All numeric stages are batched device ops; only track assembly runs on the
host (integer union-find).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from densepoints.config import MatchingConfig, OptimizeConfig, SeedConfig
from densepoints.core.cameras import Cameras
from densepoints.features.descriptors import brief_pattern, compute_descriptors
from densepoints.features.detector import detect_keypoints
from densepoints.features.matching import (
    direct_epipolar_pair,
    direct_epipolar_pair_topk,
    filter_matches_epipolar,
    match_pair,
    match_pair_absolute,
)
from densepoints.features.tracks import (
    build_tracks,
    build_tracks_onehop,
    triangulate_tracks,
)
from densepoints.geometry.fundamental import fundamental_matrices_for_pairs
from densepoints.pmvs.patch import PatchState
from densepoints.pmvs.visibility import classify_views
from densepoints.utils import log

__all__ = ["generate_seed_points", "create_patches_from_points", "default_pairs"]


def default_pairs(num_views: int) -> np.ndarray:
    """All unordered view pairs (matcher.cpp:185-204)."""
    a, b = np.triu_indices(num_views, k=1)
    return np.stack([a, b], axis=1).astype(np.int32)


def covisibility_pairs(cameras: Cameras, max_pairs_per_view: int) -> np.ndarray:
    """Nearest-neighbor pair graph for large scenes.

    The reference matches all C(V,2) pairs; on 50+-view scans that is
    quadratic waste — most pairs share no surface. Each view pairs with its
    `max_pairs_per_view` nearest camera centers (a cheap covisibility
    proxy; SURVEY.md §2.4 "later: covisibility-pruned pair graph").
    """
    C = np.asarray(cameras.C, np.float64)
    V = len(C)
    if max_pairs_per_view <= 0 or max_pairs_per_view >= V - 1:
        return default_pairs(V)
    d = np.linalg.norm(C[:, None] - C[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    pairs = set()
    for v in range(V):
        for n in np.argsort(d[v])[:max_pairs_per_view]:
            pairs.add((min(v, int(n)), max(v, int(n))))
    return np.asarray(sorted(pairs), np.int32)


def _viewsharded_features(mesh, images, config: MatchingConfig):
    """Detect (and if needed describe) with each device owning a VIEW slice.

    The per-view front-end is embarrassingly view-parallel; on a multi-host
    mesh this splits detection/description work 1/n per process (SURVEY.md
    §5.7 per-host image partitioning) instead of every process running the
    full stack. Outputs are all-gathered to replicated afterwards — small
    relative to images (keypoints + descriptors, one transfer per run) — so
    the matching/track stages stay byte-identical to the single-process
    path. Returns (xy, resp, valid, desc-or-None), replicated.
    """
    from jax.sharding import PartitionSpec
    from densepoints.parallel.mesh import PATCH_AXIS, replicate

    V, H, W = images.shape
    n = mesh.devices.size
    padV = (-V) % n
    imgs = jnp.pad(jnp.asarray(images), ((0, padV), (0, 0), (0, 0)))
    want_desc = config.matcher in ("hamming_knn", "hamming_absolute")
    pattern = (
        jnp.asarray(
            brief_pattern(config.descriptor_bits, config.descriptor_patch_radius)
        )
        if want_desc
        else None
    )
    shard_shapes = []  # trace-time evidence of the per-device work split

    def local(im):
        shard_shapes.append(im.shape)
        xy, resp, valid = detect_keypoints(
            im,
            cell_size=config.keypoint_cell_size,
            max_per_cell=config.max_keypoints_per_cell,
            max_keypoints=config.max_keypoints_per_view,
            k=config.harris_k,
            border=config.descriptor_patch_radius + 1,
            method=config.detector,
            fast_threshold=config.fast_threshold,
        )
        if want_desc:
            desc = compute_descriptors(im, xy, pattern)
            return xy, resp, valid, desc
        return xy, resp, valid

    spec = PartitionSpec(PATCH_AXIS)
    out = jax.jit(
        jax.shard_map(local, mesh=mesh, in_specs=spec, out_specs=spec),
        out_shardings=replicate(mesh),  # the one small all-gather
    )(imgs)
    out = tuple(o[:V] for o in out)
    if not want_desc:
        out = out + (None,)
    xy, resp, valid, desc = out
    return xy, resp, valid, desc, shard_shapes


_PAIR_CHUNK_BYTES = 2 << 30  # peak per-dispatch distance-matrix budget


def _pair_chunk(n_keypoints: int) -> int:
    """Pairs per dispatch so the (C, N, N) f32 distance block stays under
    the budget (C=32 at N=4096; C=2 at N=16384)."""
    return max(1, min(32, _PAIR_CHUNK_BYTES // max(4 * n_keypoints**2, 1)))


def _chunked_pair_map(fn, F_dev, i1, i2, n_keypoints, *shared):
    """vmap `fn` over view pairs in fixed-size chunks.

    A flat vmap over all pairs materializes every pair's (N, N) f32
    distance matrix at once — 285 pairs x 4096^2 x 4 B ~ 19 GB for a DTU
    scan's pruned pair list at N=4096 keypoints. Chunks of `_pair_chunk(N)`
    pairs bound that block to `_PAIR_CHUNK_BYTES` at any N while keeping
    each dispatch one fixed compiled shape (the tail chunk is padded with
    pair 0 and sliced off).

    `shared` arrays (keypoints/descriptors/valid masks) are passed as jit
    OPERANDS, never closure captures: captured arrays embed as constants
    in the compiled program, which then carries hundreds of MB of
    descriptors at kp=16384 and compiles slowly.
    """
    P = F_dev.shape[0]
    C = _pair_chunk(n_keypoints)
    vfn = jax.jit(jax.vmap(fn, in_axes=(0, 0, 0) + (None,) * len(shared)))
    if P <= C:
        return vfn(F_dev, i1, i2, *shared)
    Pp = -(-P // C) * C
    padp = lambda a: jnp.concatenate(
        [a, jnp.broadcast_to(a[:1], (Pp - P,) + a.shape[1:])], axis=0
    )
    Fp, i1p, i2p = padp(F_dev), padp(i1), padp(i2)
    outs = [
        vfn(Fp[c : c + C], i1p[c : c + C], i2p[c : c + C], *shared)
        for c in range(0, Pp, C)
    ]
    return jnp.concatenate(outs, axis=0)[:P]


def generate_seed_points(
    images: jax.Array,
    cameras: Cameras,
    config: MatchingConfig = MatchingConfig(),
    pairs: np.ndarray | None = None,
    mesh=None,
):
    """Detect, match, track and triangulate -> (S, 3) seed points (host).

    Also returns the track masks for diagnostics: (points, obs, mask).
    With `mesh`, the per-view detection/description front-end is sharded
    over the mesh devices (each process computes only its view slice) and
    the small keypoint/descriptor tensors are all-gathered; everything
    downstream is identical.
    """
    V = cameras.num_views
    if pairs is None:
        pairs = covisibility_pairs(cameras, config.max_pairs_per_view)
    desc = None
    if mesh is not None:
        xy, resp, valid, desc, _ = _viewsharded_features(mesh, images, config)
    else:
        xy, resp, valid = detect_keypoints(
            images,
            cell_size=config.keypoint_cell_size,
            max_per_cell=config.max_keypoints_per_cell,
            max_keypoints=config.max_keypoints_per_view,
            k=config.harris_k,
            border=config.descriptor_patch_radius + 1,
            method=config.detector,
            fast_threshold=config.fast_threshold,
        )
    log.info(
        "detected keypoints per view: %s",
        np.asarray(jnp.sum(valid, axis=1)).tolist(),
    )
    F_pairs = fundamental_matrices_for_pairs(
        np.asarray(cameras.P, np.float64), pairs
    ).astype(np.float32)
    F_dev = jnp.asarray(F_pairs)
    i1 = jnp.asarray(pairs[:, 0])
    i2 = jnp.asarray(pairs[:, 1])

    if config.matcher in ("hamming_knn", "hamming_absolute"):
        if desc is None:
            pattern = jnp.asarray(
                brief_pattern(
                    config.descriptor_bits, config.descriptor_patch_radius
                )
            )
            desc = compute_descriptors(images, xy, pattern)

        def _one(F, a, b, desc, xy, valid):
            if config.matcher == "hamming_knn":
                m, _ = match_pair(
                    desc[a], desc[b], valid[a], valid[b], config.lowe_ratio
                )
            else:
                # The reference's FLANN/LSH path: nearest neighbor with an
                # absolute Hamming cutoff (matcher.cpp:227-240).
                m, _ = match_pair_absolute(
                    desc[a], desc[b], valid[a], valid[b],
                    config.max_hamming_distance,
                )
            return filter_matches_epipolar(
                F, xy[a], xy[b], m, config.max_epipolar_distance
            )

        matches = _chunked_pair_map(
            _one, F_dev, i1, i2, xy.shape[1], desc, xy, valid
        )
    elif config.matcher == "epipolar":

        def _one(F, a, b, xy, valid):
            m, _ = direct_epipolar_pair(
                F, xy[a], xy[b], valid[a], valid[b], config.max_epipolar_distance
            )
            return m

        matches = _chunked_pair_map(
            _one, F_dev, i1, i2, xy.shape[1], xy, valid
        )
    elif config.matcher == "epipolar_all":
        # Reference semantics (matcher.cpp:267-317): EVERY pair within the
        # threshold matches (capped at epipolar_topk partners/keypoint),
        # consumed by ONE-HOP track assembly (no union-find transitivity).
        def _one(F, a, b, xy, valid):
            m, _ = direct_epipolar_pair_topk(
                F, xy[a], xy[b], valid[a], valid[b],
                config.max_epipolar_distance, config.epipolar_topk,
            )
            return m

        matches = _chunked_pair_map(
            _one, F_dev, i1, i2, xy.shape[1], xy, valid
        )  # (P, N, K)
        n_matches = np.asarray(jnp.sum(matches >= 0, axis=(1, 2)))
        log.info("matches per pair (all-pairs): %s", n_matches.tolist())
        obs, mask, _ = build_tracks_onehop(
            V, np.asarray(xy), pairs, np.asarray(matches), min_views=2
        )
        points = triangulate_tracks(np.asarray(cameras.P), obs, mask)
        log.info("tracks (one-hop): %d -> seed points", len(points))
        return points, obs, mask
    else:
        raise ValueError(f"unknown matcher {config.matcher!r}")

    n_matches = np.asarray(jnp.sum(matches >= 0, axis=1))
    log.info("matches per pair: %s", n_matches.tolist())

    obs, mask, _ = build_tracks(
        V, np.asarray(xy), pairs, np.asarray(matches), min_views=2
    )
    points = triangulate_tracks(np.asarray(cameras.P), obs, mask)
    log.info("tracks: %d -> seed points", len(points))
    return points, obs, mask


def create_patches_from_points(
    cameras: Cameras,
    points: np.ndarray,
    optimize_config: OptimizeConfig = OptimizeConfig(),
    seed_config: SeedConfig = SeedConfig(),
) -> PatchState:
    """Seed patches from triangulated points (seed.cpp:26-86 semantics)."""
    points = jnp.asarray(points, jnp.float32)
    if points.shape[0] > seed_config.max_seeds:
        points = points[: seed_config.max_seeds]
    # Reference image: nearest camera center.
    d = jnp.linalg.norm(
        points[:, None, :] - cameras.C[None, :, :], axis=-1
    )  # (S, V)
    ref = jnp.argmin(d, axis=1).astype(jnp.int32)
    C_ref = cameras.C[ref]
    rays = points - C_ref
    normal = rays / jnp.maximum(
        jnp.linalg.norm(rays, axis=-1, keepdims=True), 1e-12
    )
    vis, cand = classify_views(
        cameras,
        points,
        normal,
        ref,
        optimize_config.visible_angle,
        optimize_config.candidate_angle,
    )
    return PatchState.create(points, normal, ref, vis, cand)
