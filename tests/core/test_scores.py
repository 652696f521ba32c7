"""Golden-value parity tests for photometric scores.

Anchors from the reference: tests/core/test_error_functions.cpp:9-15.
"""
import jax.numpy as jnp
import numpy as np

from densepoints.core import ncc_score, ncc_score_by_channel, ssd_score

A = np.array([[1, 2, 3], [-1, -2, -3], [1, 2, 3]], dtype=np.float32)
B = np.array([[2, 0, 5], [-4, 5, -2], [-1, 0, -3]], dtype=np.float32)


def test_ncc_golden_value():
    score = ncc_score(A.reshape(-1), B.reshape(-1))
    np.testing.assert_allclose(float(score), 0.1005653, rtol=1e-5)


def test_ncc_self_is_one():
    score = ncc_score(A.reshape(-1), A.reshape(-1))
    np.testing.assert_allclose(float(score), 1.0, rtol=1e-6)


def test_ncc_batched_matches_single():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 49)).astype(np.float32) * 40
    b = rng.standard_normal((16, 49)).astype(np.float32) * 40
    batched = np.asarray(ncc_score(a, b))
    single = np.array([float(ncc_score(a[i], b[i])) for i in range(16)])
    np.testing.assert_allclose(batched, single, rtol=1e-5)


def test_ncc_masked_equals_dense_on_valid_prefix():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((121,)).astype(np.float32) * 30
    b = rng.standard_normal((121,)).astype(np.float32) * 30
    pad_a = np.concatenate([a, np.full(7, 999.0, np.float32)])
    pad_b = np.concatenate([b, np.full(7, -999.0, np.float32)])
    mask = np.concatenate([np.ones(121, bool), np.zeros(7, bool)])
    np.testing.assert_allclose(
        float(ncc_score(pad_a, pad_b, jnp.asarray(mask))),
        float(ncc_score(a, b)),
        rtol=1e-4,
    )


def test_ncc_empty_mask_returns_sentinel():
    a = np.zeros((8,), np.float32)
    mask = np.zeros((8,), bool)
    assert float(ncc_score(a, a, jnp.asarray(mask))) == -1.0


def test_ncc_constant_patches_clamped_denominator():
    # Population std == 0 on both sides -> denom clamped to 0.1 -> score 0.
    a = np.full((9,), 5.0, np.float32)
    assert float(ncc_score(a, a)) == 0.0


def test_ssd():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([2.0, 2.0, 5.0], np.float32)
    np.testing.assert_allclose(float(ssd_score(a, b)), (1 + 0 + 4) / 3.0)


def test_ncc_by_channel_self_positive():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 255, size=(25, 3)).astype(np.float32)
    score = float(ncc_score_by_channel(a, a))
    # Self-score: each channel contributes N*var/max(var, eps) ~= N -> /(N*3) ~= 1.
    np.testing.assert_allclose(score, 1.0, rtol=1e-4)


def test_sad():
    from densepoints.core import sad_score

    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([2.0, 2.0, 5.0], np.float32)
    np.testing.assert_allclose(float(sad_score(a, b)), (1 + 0 + 2) / 3.0)
    mask = jnp.asarray(np.array([True, True, False]))
    np.testing.assert_allclose(float(sad_score(a, b, mask)), 0.5)
    empty = jnp.asarray(np.zeros(3, bool))
    assert float(sad_score(a, b, empty)) == -1.0
