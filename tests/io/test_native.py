"""Native C++ runtime tests (built on demand; skipped if no toolchain)."""
import numpy as np
import pytest

from densepoints.native import available

pytestmark = pytest.mark.skipif(
    not available(), reason="native library not built"
)


def test_union_matches_matches_python():
    from densepoints.native import tracks as nt

    num_views, N = 3, 5
    pairs = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    matches = np.full((3, N), -1, np.int32)
    matches[0, 0] = 2  # (0,0) ~ (1,2)
    matches[1, 2] = 4  # (1,2) ~ (2,4)
    matches[2, 3] = 3  # (0,3) ~ (2,3)
    parent = nt.union_matches(num_views, N, pairs, matches)
    roots = nt.roots(parent)
    # Track {(0,0),(1,2),(2,4)} shares a root; {(0,3),(2,3)} shares another.
    assert roots[0 * N + 0] == roots[1 * N + 2] == roots[2 * N + 4]
    assert roots[0 * N + 3] == roots[2 * N + 3]
    assert roots[0 * N + 0] != roots[0 * N + 3]
    # Deterministic smaller-root-wins: the track root is its smallest node.
    assert roots[0 * N + 0] == 0
    assert roots[0 * N + 3] == 3


def test_native_ply_roundtrip(tmp_path, rng):
    from densepoints.io import read_ply
    from densepoints.native.ply import write_ply_native

    pos = rng.standard_normal((1000, 3)).astype(np.float32)
    nrm = rng.standard_normal((1000, 3)).astype(np.float32)
    col = rng.integers(0, 256, (1000, 3)).astype(np.uint8)
    path = tmp_path / "native.ply"
    assert write_ply_native(path, pos, nrm, col)
    out = read_ply(path)
    np.testing.assert_allclose(out["positions"], pos)
    np.testing.assert_allclose(out["normals"], nrm)
    np.testing.assert_array_equal(out["colors"], col)


def test_big_cloud_auto_native(tmp_path, rng):
    from densepoints.io import read_ply, write_ply

    pos = rng.standard_normal((20000, 3)).astype(np.float32)
    path = tmp_path / "big.ply"
    write_ply(path, pos)
    out = read_ply(path)
    np.testing.assert_allclose(out["positions"], pos)
    assert b"native" in path.read_bytes()[:200]


def test_track_builder_uses_native_and_matches(rng):
    """build_tracks gives identical tracks with and without native."""
    import densepoints.features.tracks as T

    num_views, N = 4, 64
    pairs = np.array([[0, 1], [0, 2], [1, 2], [2, 3]], np.int32)
    matches = np.full((4, N), -1, np.int32)
    m = rng.integers(0, N, 40)
    for k in range(20):
        matches[rng.integers(0, 4), rng.integers(0, N)] = m[k]
    kp = rng.uniform(0, 100, (num_views, N, 2)).astype(np.float32)

    obs_n, mask_n, idx_n = T.build_tracks(num_views, kp, pairs, matches)
    # Force the python fallback.
    import densepoints.native as nat

    saved = nat._lib, nat._tried
    nat._lib, nat._tried = None, True
    try:
        obs_p, mask_p, idx_p = T.build_tracks(num_views, kp, pairs, matches)
    finally:
        nat._lib, nat._tried = saved
    np.testing.assert_array_equal(mask_n, mask_p)
    np.testing.assert_allclose(obs_n, obs_p)
    np.testing.assert_array_equal(idx_n, idx_p)
