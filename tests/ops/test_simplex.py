"""Batched Nelder-Mead tests."""
import jax.numpy as jnp
import numpy as np

from densepoints.ops.simplex import nelder_mead


def test_batched_quadratic():
    rng = np.random.default_rng(0)
    targets = jnp.asarray(rng.standard_normal((64, 3)).astype(np.float32))

    def f(x):  # (B, K, 3) -> (B, K); lane b targets targets[b]
        return jnp.sum((x - targets[:, None, :]) ** 2, axis=-1)

    x0 = jnp.zeros((64, 3), jnp.float32)
    x, fb, iters = nelder_mead(
        f, x0, jnp.array([0.5, 0.5, 0.5]), max_iterations=200, tolerance=1e-8
    )
    np.testing.assert_allclose(np.asarray(x), np.asarray(targets), atol=5e-3)
    assert np.all(np.asarray(fb) < 1e-4)


def test_anisotropic_objective():
    # Mimics the patch objective's scale mix: one tight dim, two loose.
    target = jnp.asarray([0.05, -0.8, 1.2], jnp.float32)
    scales = jnp.asarray([100.0, 1.0, 1.0], jnp.float32)

    def f(x):
        return jnp.sum(scales * (x - target) ** 2, axis=-1)

    x0 = jnp.zeros((4, 3), jnp.float32)
    x, fb, _ = nelder_mead(
        f, x0, jnp.array([0.02, 0.2, 0.2]), max_iterations=500, tolerance=1e-10
    )
    np.testing.assert_allclose(np.asarray(x)[0], np.asarray(target), atol=2e-2)


def test_termination_by_tolerance():
    def f(x):
        return jnp.sum(x**2, axis=-1)

    x0 = jnp.full((8, 3), 2.0, jnp.float32)
    _, _, iters = nelder_mead(
        f, x0, jnp.array([0.02, 0.2, 0.2]), max_iterations=500, tolerance=1e-4
    )
    # Should converge well before 500 iterations.
    assert np.all(np.asarray(iters) < 500)
