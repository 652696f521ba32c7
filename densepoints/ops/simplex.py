"""Batched Nelder-Mead (downhill simplex) minimization.

Reference parity: the reference optimizes every patch one-by-one with
OpenCV's `cv::DownhillSolver` (optimization_opencv.cpp:44-78: start x0,
per-dimension init step, max 500 iterations, eps 1e-4). Batched redesign: ONE
Nelder-Mead drives the whole batch — the simplex state is (B, D+1, D) and
every step evaluates the objective for all B lanes at once; converged lanes
are frozen by masking. Per iteration there are exactly two batched objective
evaluations (reflection, then a per-lane select of expansion / outside /
inside contraction); the rarely-taken shrink step is replaced by accepting
the contraction point, which preserves convergence on smooth objectives
while keeping the eval count static (SURVEY.md §7 "hard parts").
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["nelder_mead"]

_ALPHA = 1.0  # reflection
_GAMMA = 2.0  # expansion
_RHO = 0.5  # contraction


def nelder_mead(
    f: Callable[[jax.Array], jax.Array],
    x0: jax.Array,
    init_step: jax.Array,
    max_iterations: int = 500,
    tolerance: float = 1e-4,
):
    """Minimize f over a batch.

    f: (B, K, D) -> (B, K) batched objective — lane b always refers to the
      same problem instance (e.g. patch b); K is an arbitrary number of
      simultaneous candidate points per lane.
    x0: (B, D) initial points; init_step: (D,) per-dim initial simplex step.
    Returns (x_best (B, D), f_best (B,), iterations_used (B,)).
    """
    B, D = x0.shape
    n_vert = D + 1
    # Initial simplex: x0 plus one step along each axis.
    offsets = jnp.concatenate(
        [jnp.zeros((1, D), x0.dtype), jnp.diag(jnp.asarray(init_step, x0.dtype))],
        axis=0,
    )  # (D+1, D)
    verts = x0[:, None, :] + offsets[None, :, :]  # (B, D+1, D)
    fvals = f(verts)  # (B, D+1)

    def body(state):
        verts, fvals, done, iters = state
        order = jnp.argsort(fvals, axis=1)  # ascending
        verts = jnp.take_along_axis(verts, order[:, :, None], axis=1)
        fvals = jnp.take_along_axis(fvals, order, axis=1)
        best, second_worst, worst = fvals[:, 0], fvals[:, -2], fvals[:, -1]
        x_worst = verts[:, -1, :]
        centroid = jnp.mean(verts[:, :-1, :], axis=1)  # (B, D)

        x_r = centroid + _ALPHA * (centroid - x_worst)
        f_r = f(x_r[:, None, :])[:, 0]

        # Second candidate per lane: expansion if reflection is a new best,
        # else outside/inside contraction.
        expand = f_r < best
        outside = f_r < worst
        x_e = centroid + _GAMMA * (centroid - x_worst)
        x_oc = centroid + _RHO * (x_r - centroid)
        x_ic = centroid - _RHO * (centroid - x_worst)
        x_2 = jnp.where(
            expand[:, None], x_e, jnp.where(outside[:, None], x_oc, x_ic)
        )
        f_2 = f(x_2[:, None, :])[:, 0]

        # Accept rules (no shrink; contraction always replaces the worst).
        # - expansion lanes: better of x_r / x_e
        # - middle lanes (best <= f_r < second_worst): x_r
        # - contraction lanes: better of contraction point and x_r
        use_2 = jnp.where(
            expand,
            f_2 < f_r,
            jnp.where(f_r < second_worst, False, f_2 < f_r),
        )
        x_new = jnp.where(use_2[:, None], x_2, x_r)
        f_new = jnp.where(use_2, f_2, f_r)

        improved = f_new < worst
        x_acc = jnp.where(improved[:, None], x_new, x_worst)
        f_acc = jnp.where(improved, f_new, worst)

        active = jnp.logical_not(done)
        verts = verts.at[:, -1, :].set(
            jnp.where(active[:, None], x_acc, verts[:, -1, :])
        )
        fvals = fvals.at[:, -1].set(jnp.where(active, f_acc, fvals[:, -1]))

        # Convergence: simplex f-value spread below tolerance (the OpenCV
        # TermCriteria::EPS analog).
        spread = jnp.max(fvals, axis=1) - jnp.min(fvals, axis=1)
        done = done | (spread < tolerance)
        iters = iters + active.astype(jnp.int32)
        return verts, fvals, done, iters

    done0 = jnp.zeros((B,), bool)
    iters0 = jnp.zeros((B,), jnp.int32)
    # while_loop with a global all-done predicate: once every lane has
    # converged the whole batch stops paying for objective evaluations
    # (lanes converge together in practice since patches share statistics).
    verts, fvals, _, iters = jax.lax.while_loop(
        lambda s: jnp.logical_and(
            jnp.max(s[3]) < max_iterations, jnp.logical_not(jnp.all(s[2]))
        ),
        lambda s: body(s),
        (verts, fvals, done0, iters0),
    )
    ib = jnp.argmin(fvals, axis=1)
    x_best = jnp.take_along_axis(verts, ib[:, None, None], axis=1)[:, 0, :]
    f_best = jnp.take_along_axis(fvals, ib[:, None], axis=1)[:, 0]
    return x_best, f_best, iters
