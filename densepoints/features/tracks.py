"""Track assembly from pairwise matches + batched triangulation.

Reference parity: `Matcher::TriangulateMatches` + `GetAllMatches`
(matcher.cpp:374-473): for each keypoint, a linear scan over all pairs
collects its direct partners and the multi-view set is DLT-triangulated.
That construction creates duplicate, one-hop-only tracks in O(kp x pairs).

Redesign: a proper union-find over (view, keypoint) nodes on the host (cheap
integer work, optionally the C++ native module), producing canonical
multi-view tracks exactly once; observations are padded to (T, V) masked
arrays and triangulated in ONE batched masked DLT on device.
"""
from __future__ import annotations

import numpy as np

from densepoints.geometry.triangulation import triangulate

__all__ = ["build_tracks", "build_tracks_onehop", "triangulate_tracks"]


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, i):
        root = i
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[i] != root:
            p[i], i = root, p[i]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # Deterministic: smaller root wins.
            if rb < ra:
                ra, rb = rb, ra
            self.parent[rb] = ra


def build_tracks(
    num_views: int,
    keypoints: np.ndarray,
    pair_list: np.ndarray,
    matches: np.ndarray,
    min_views: int = 2,
):
    """Union-find track building.

    keypoints: (V, N, 2); pair_list: (P, 2) view-index pairs;
    matches: (P, N) int32 — matches[p, i] = keypoint index in pair_list[p][1]
    matched to keypoint i of pair_list[p][0], or -1.

    Returns (obs (T, V, 2) float32, mask (T, V) bool, kp_index (T, V) int32)
    with one row per track seen in >= min_views views.
    """
    keypoints = np.asarray(keypoints)
    matches = np.asarray(matches)
    N = keypoints.shape[1]
    uf = _UnionFind(num_views * N)
    try:
        from densepoints.native import tracks as native_tracks  # noqa

        have_native = native_tracks.available()
    except Exception:
        have_native = False
    if have_native:
        parent = native_tracks.union_matches(
            num_views, N, np.asarray(pair_list, np.int32), matches.astype(np.int32)
        )
        uf.parent = parent.astype(np.int64)
    else:
        for p, (a, b) in enumerate(pair_list):
            m = matches[p]
            js = np.nonzero(m >= 0)[0]
            for i in js:
                uf.union(int(a) * N + int(i), int(b) * N + int(m[i]))

    roots = np.array([uf.find(i) for i in range(num_views * N)])
    # Group nodes by root; only roots with >= min_views distinct views count.
    order = np.argsort(roots, kind="stable")
    sorted_roots = roots[order]
    boundaries = np.nonzero(
        np.diff(sorted_roots, prepend=sorted_roots[0] - 1)
    )[0]
    obs_rows, mask_rows, idx_rows = [], [], []
    for gi in range(len(boundaries)):
        start = boundaries[gi]
        end = boundaries[gi + 1] if gi + 1 < len(boundaries) else len(order)
        nodes = order[start:end]
        if len(nodes) < min_views:
            continue
        views = nodes // N
        kps = nodes % N
        # Keep the first keypoint per view (deterministic by node order).
        seen = {}
        for v, kp in zip(views, kps):
            if v not in seen:
                seen[v] = kp
        if len(seen) < min_views:
            continue
        obs = np.zeros((num_views, 2), np.float32)
        mask = np.zeros((num_views,), bool)
        kpi = np.full((num_views,), -1, np.int32)
        for v, kp in seen.items():
            obs[v] = keypoints[v, kp]
            mask[v] = True
            kpi[v] = kp
        obs_rows.append(obs)
        mask_rows.append(mask)
        idx_rows.append(kpi)
    if not obs_rows:
        return (
            np.zeros((0, num_views, 2), np.float32),
            np.zeros((0, num_views), bool),
            np.zeros((0, num_views), np.int32),
        )
    return np.stack(obs_rows), np.stack(mask_rows), np.stack(idx_rows)


def triangulate_tracks(P_all, obs, mask):
    """Batched masked DLT of all tracks. P_all: (V, 3, 4) -> (T, 3)."""
    import jax.numpy as jnp

    if obs.shape[0] == 0:
        return np.zeros((0, 3), np.float32)
    return np.asarray(
        triangulate(
            jnp.asarray(P_all, jnp.float32),
            jnp.asarray(obs, jnp.float32),
            jnp.asarray(mask),
        )
    )


def build_tracks_onehop(
    num_views: int,
    keypoints: np.ndarray,
    pair_list: np.ndarray,
    matches_topk: np.ndarray,
    min_views: int = 2,
):
    """One-hop track assembly (reference semantics, matcher.cpp:374-413).

    The reference's `GetAllMatches` collects, for each keypoint, its direct
    partners across every pair — NO transitive merging (unlike the
    union-find path, which dedups multi-view tracks). With all-pairs
    epipolar matching this yields one (possibly noisy) track per matched
    keypoint, the behavior `DirectEpipolarMatching` feeds.

    matches_topk: (P, N, K) int32 — partner keypoint indices in
    pair_list[p][1] for each keypoint of pair_list[p][0], -1 empty.
    Returns (obs (T, V, 2) float32, mask (T, V) bool, kp_index (T, V) int32).
    """
    keypoints = np.asarray(keypoints)
    matches_topk = np.asarray(matches_topk)
    V, N = num_views, keypoints.shape[1]
    obs_list, mask_list, idx_list = [], [], []
    # Partners of keypoint (a, i): every (b, j) with j in matches_topk for
    # a pair (a, b). One track per LEFT keypoint that matched anywhere.
    partners: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for p, (a, b) in enumerate(pair_list):
        m = matches_topk[p]  # (N, K)
        js, ks = np.nonzero(m >= 0)
        for i, kk in zip(js, ks):
            partners.setdefault((int(a), int(i)), []).append(
                (int(b), int(m[i, kk]))
            )
    for (a, i), plist in partners.items():
        obs = np.zeros((V, 2), np.float32)
        mask = np.zeros((V,), bool)
        kp_idx = np.full((V,), -1, np.int32)
        obs[a] = keypoints[a, i]
        mask[a] = True
        kp_idx[a] = i
        for b, j in plist:
            if not mask[b]:  # first partner in a view wins
                obs[b] = keypoints[b, j]
                mask[b] = True
                kp_idx[b] = j
        if mask.sum() >= min_views:
            obs_list.append(obs)
            mask_list.append(mask)
            idx_list.append(kp_idx)
    if not obs_list:
        return (
            np.zeros((0, V, 2), np.float32),
            np.zeros((0, V), bool),
            np.zeros((0, V), np.int32),
        )
    return np.stack(obs_list), np.stack(mask_list), np.stack(idx_list)
