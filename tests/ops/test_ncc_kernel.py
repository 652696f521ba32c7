"""Row-wise NCC (`ops.ncc.ncc_pairs`) against a float64 numpy NCC."""
import numpy as np
import jax.numpy as jnp

from densepoints.ops.ncc import ncc_pairs


def _numpy_ncc(a, b, mask=None):
    """Population-statistics NCC with the 0.1 denominator clamp, f64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    m = np.ones_like(a) if mask is None else np.asarray(mask, np.float64)
    n = m.sum(axis=1)
    ns = np.maximum(n, 1.0)
    ca = (a - (a * m).sum(axis=1, keepdims=True) / ns[:, None]) * m
    cb = (b - (b * m).sum(axis=1, keepdims=True) / ns[:, None]) * m
    cov = (ca * cb).sum(axis=1) / ns
    sa = np.sqrt((ca * ca).sum(axis=1) / ns)
    sb = np.sqrt((cb * cb).sum(axis=1) / ns)
    score = cov / np.maximum(sa * sb, 0.1)
    return np.where(n > 0, score, -1.0)


def test_kernel_matches_reference(rng):
    a = rng.uniform(0, 255, (37, 121)).astype(np.float32)
    b = rng.uniform(0, 255, (37, 121)).astype(np.float32)
    got = np.asarray(ncc_pairs(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _numpy_ncc(a, b), rtol=2e-5, atol=1e-5)


def test_kernel_masked(rng):
    a = rng.uniform(0, 255, (8, 121)).astype(np.float32)
    b = rng.uniform(0, 255, (8, 121)).astype(np.float32)
    mask = rng.uniform(size=(8, 121)) > 0.3
    mask[0] = False  # empty row -> -1 sentinel
    got = np.asarray(
        ncc_pairs(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    )
    np.testing.assert_allclose(
        got, _numpy_ncc(a, b, mask), rtol=2e-5, atol=1e-5
    )
    assert got[0] == -1.0


def test_kernel_golden_value():
    A = np.array([1, 2, 3, -1, -2, -3, 1, 2, 3], np.float32)
    B = np.array([2, 0, 5, -4, 5, -2, -1, 0, -3], np.float32)
    got = np.asarray(ncc_pairs(jnp.asarray(A[None]), jnp.asarray(B[None])))
    np.testing.assert_allclose(got[0], 0.1005653, rtol=1e-5)
    np.testing.assert_allclose(got[0], _numpy_ncc(A[None], B[None])[0],
                               rtol=1e-6)
