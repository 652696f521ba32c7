"""Bundle adjustment: batched Jacobians + matrix-free Schur-complement CG.

North-star addition (BASELINE.json): the reference has no camera refinement
at all. Batched design:

  * per-observation residuals r = project(K, R0 dR(w), C0 + dC; X) - obs
    with Huber robustification; Jacobians for ALL observations in one
    vmapped jacfwd (fixed (2,6) and (2,3) blocks — no sparse assembly);
  * Levenberg-Marquardt normal equations reduced by the Schur complement
    over points; the reduced camera system S = U - W V^-1 W^T is never
    materialized: CG applies S x via two segment-sums per iteration
    (observations -> points -> observations), which is bandwidth-optimal
    and shards over observations with one psum per product when
    distributed;
  * the point update is the standard back-substitution
    dX_p = V_p^-1 (g_p - W^T dx_c).

Camera intrinsics stay fixed (MVS input cameras are pre-calibrated);
extrinsics are parametrized as a local axis-angle rotation delta and a
camera-center delta.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

__all__ = [
    "BAProblem",
    "run_ba",
    "run_ba_sharded",
    "reprojection_rmse",
    "rodrigues",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BAProblem:
    """K/R0/C0: (V,3,3),(V,3,3),(V,3); points0: (N,3);
    obs_point/obs_view: (M,) int32; obs_xy: (M,2); obs_mask: (M,) bool."""

    K: jax.Array
    R0: jax.Array
    C0: jax.Array
    points0: jax.Array
    obs_point: jax.Array
    obs_view: jax.Array
    obs_xy: jax.Array
    obs_mask: jax.Array


def rodrigues(w: jax.Array) -> jax.Array:
    """Axis-angle (...,3) -> rotation matrix (...,3,3).

    R = I + A [w]_x + B [w]_x^2 with A = sin(t)/t, B = (1-cos t)/t^2 and
    Taylor fallbacks near t = 0 guarded by the double-where trick so
    jacfwd/jacrev are exact AND finite at w = 0 (BA linearizes there every
    outer iteration).
    """
    t2 = jnp.sum(w * w, axis=-1)
    small = t2 < 1e-8
    t2_safe = jnp.where(small, 1.0, t2)
    t_safe = jnp.sqrt(t2_safe)
    A = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(t_safe) / t_safe)
    B = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(t_safe)) / t2_safe)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    Wx = jnp.stack(
        [
            jnp.stack([zero, -wz, wy], -1),
            jnp.stack([wz, zero, -wx], -1),
            jnp.stack([-wy, wx, zero], -1),
        ],
        -2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), Wx.shape)
    return eye + A[..., None, None] * Wx + B[..., None, None] * (Wx @ Wx)


def _project_residual(cam6, X, K, R0, C0, obs_xy):
    """Residual of one observation. cam6 = (w(3), dC(3))."""
    hi = jax.lax.Precision.HIGHEST  # pixel coords: never TF32/bf16
    # (vmapped 3x3 products batch into matmuls under vmap)
    R = jnp.matmul(R0, rodrigues(cam6[:3]), precision=hi)
    C = C0 + cam6[3:]
    cam = jnp.matmul(R, X - C, precision=hi)
    pix_h = jnp.matmul(K, cam, precision=hi)
    pix = pix_h[:2] / pix_h[2]
    return pix - obs_xy


def _residuals_and_jacobians(problem: BAProblem, cam_params, points):
    """(r (M,2), Jc (M,2,6), Jp (M,2,3)) for all observations."""

    def one(cam6, X, K, R0, C0, obs_xy):
        r = _project_residual(cam6, X, K, R0, C0, obs_xy)
        Jc = jax.jacfwd(_project_residual, argnums=0)(
            cam6, X, K, R0, C0, obs_xy
        )
        Jp = jax.jacfwd(_project_residual, argnums=1)(
            cam6, X, K, R0, C0, obs_xy
        )
        return r, Jc, Jp

    cam6 = cam_params[problem.obs_view]
    X = points[problem.obs_point]
    K = problem.K[problem.obs_view]
    R0 = problem.R0[problem.obs_view]
    C0 = problem.C0[problem.obs_view]
    return jax.vmap(one)(cam6, X, K, R0, C0, problem.obs_xy)


def _huber_weights(r: jax.Array, delta: float) -> jax.Array:
    """sqrt IRLS weights per observation: w = min(1, delta/|r|)."""
    norm = jnp.linalg.norm(r, axis=-1)
    return jnp.sqrt(jnp.minimum(1.0, delta / jnp.maximum(norm, 1e-12)))


def _schur_matvec(x, U, W, Vinv, obs_view, obs_point, num_views, reduce):
    """Apply S = U - W V^-1 W^T to stacked camera deltas x (V,6).

    `reduce` is identity on one device; under `run_ba_sharded` it is a psum
    over the observation shards (the camera/point blocks stay replicated,
    SURVEY.md §2.7(d)) — two small collectives per CG product ((N,3) and
    (V,6)), both riding ICI.
    """
    y1 = jnp.einsum("vij,vj->vi", U, x)
    xw = x[obs_view]  # (M, 6)
    t = jnp.einsum("mij,mi->mj", W, xw)  # (M, 3) = W^T x per obs
    t_p = reduce(
        jax.ops.segment_sum(t, obs_point, num_segments=Vinv.shape[0])
    )
    u_p = jnp.einsum("pij,pj->pi", Vinv, t_p)
    z = jnp.einsum("mij,mj->mi", W, u_p[obs_point])  # (M, 6)
    y2 = reduce(jax.ops.segment_sum(z, obs_view, num_segments=num_views))
    return y1 - y2


def _cg(matvec, b, iterations: int):
    x = jnp.zeros_like(b)
    r = b
    p = r
    rs = jnp.vdot(r, r)

    def body(_, state):
        x, r, p, rs = state
        Ap = matvec(p)
        alpha = rs / jnp.maximum(jnp.vdot(p, Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / jnp.maximum(rs, 1e-20)) * p
        return x, r, p, rs_new

    x, _, _, _ = jax.lax.fori_loop(0, iterations, body, (x, r, p, rs))
    return x


def _ba_core(
    problem: BAProblem,
    max_outer_iterations: int,
    cg_iterations: int,
    damping: float,
    robust_delta: float,
    reduce=lambda x: x,
):
    """LM with Schur-complement CG. Returns (R (V,3,3), C (V,3),
    points (N,3), final mean reprojection cost).

    `reduce` sums observation-shard partials (identity on one device; psum
    under `run_ba_sharded`). Everything derived per-camera or per-point is
    replicated after the reduction, so the LM/CG control flow is identical
    on every device."""
    V = problem.K.shape[0]
    N = problem.points0.shape[0]
    mask = problem.obs_mask.astype(problem.obs_xy.dtype)
    n_obs = jnp.maximum(reduce(jnp.sum(mask)), 1.0)

    def cost(cam_params, points):
        r, _, _ = _residuals_and_jacobians(problem, cam_params, points)
        w = _huber_weights(r, robust_delta)
        return reduce(
            jnp.sum(jnp.sum((w[:, None] * r) ** 2, -1) * mask)
        ) / n_obs

    def step(state, _):
        cam_params, points, lam = state
        r, Jc, Jp = _residuals_and_jacobians(problem, cam_params, points)
        w = (_huber_weights(r, robust_delta) * mask)[:, None]
        r = r * w
        Jc = Jc * w[:, :, None]
        Jp = Jp * w[:, :, None]

        U = reduce(jax.ops.segment_sum(
            jnp.einsum("mri,mrj->mij", Jc, Jc), problem.obs_view, num_segments=V
        ))
        Vp = reduce(jax.ops.segment_sum(
            jnp.einsum("mri,mrj->mij", Jp, Jp), problem.obs_point, num_segments=N
        ))
        W = jnp.einsum("mri,mrj->mij", Jc, Jp)  # (M, 6, 3)
        g_c = -reduce(jax.ops.segment_sum(
            jnp.einsum("mri,mr->mi", Jc, r), problem.obs_view, num_segments=V
        ))
        g_p = -reduce(jax.ops.segment_sum(
            jnp.einsum("mri,mr->mi", Jp, r), problem.obs_point, num_segments=N
        ))

        eye6 = jnp.eye(6, dtype=U.dtype)
        eye3 = jnp.eye(3, dtype=U.dtype)
        U = U + lam * eye6[None]
        Vp = Vp + lam * eye3[None]
        Vinv = jnp.linalg.inv(Vp)

        # Reduced RHS: b = g_c - W V^-1 g_p (gathered per observation).
        u_p = jnp.einsum("pij,pj->pi", Vinv, g_p)
        b_from_points = reduce(jax.ops.segment_sum(
            jnp.einsum("mij,mj->mi", W, u_p[problem.obs_point]),
            problem.obs_view,
            num_segments=V,
        ))
        b = (g_c - b_from_points).reshape(-1)

        mv = lambda x: _schur_matvec(
            x.reshape(V, 6), U, W, Vinv, problem.obs_view,
            problem.obs_point, V, reduce,
        ).reshape(-1)
        dx_c = _cg(mv, b, cg_iterations).reshape(V, 6)

        # Back-substitute points: dX = V^-1 (g_p - W^T dx_c).
        t = reduce(jax.ops.segment_sum(
            jnp.einsum("mij,mi->mj", W, dx_c[problem.obs_view]),
            problem.obs_point,
            num_segments=N,
        ))
        dx_p = jnp.einsum("pij,pj->pi", Vinv, g_p - t)

        new_cam = cam_params + dx_c
        new_points = points + dx_p
        old_cost = cost(cam_params, points)
        new_cost = cost(new_cam, new_points)
        accept = new_cost < old_cost
        cam_params = jnp.where(accept, new_cam, cam_params)
        points = jnp.where(accept, new_points, points)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        return (cam_params, points, lam), new_cost

    cam0 = jnp.zeros((V, 6), problem.points0.dtype)
    (cam_params, points, _), costs = jax.lax.scan(
        step,
        (cam0, problem.points0, jnp.asarray(damping, problem.points0.dtype)),
        None,
        length=max_outer_iterations,
    )
    R = problem.R0 @ rodrigues(cam_params[:, :3])
    C = problem.C0 + cam_params[:, 3:]
    return R, C, points, cost(cam_params, points)


@functools.partial(
    jax.jit,
    static_argnames=("max_outer_iterations", "cg_iterations"),
)
def run_ba(
    problem: BAProblem,
    max_outer_iterations: int = 10,
    cg_iterations: int = 50,
    damping: float = 1e-4,
    robust_delta: float = 2.0,
):
    """Single-device LM + Schur CG (see `_ba_core`)."""
    return _ba_core(
        problem, max_outer_iterations, cg_iterations, damping, robust_delta
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "max_outer_iterations", "cg_iterations"),
)
def run_ba_sharded(
    problem: BAProblem,
    mesh,
    max_outer_iterations: int = 10,
    cg_iterations: int = 50,
    damping: float = 1e-4,
    robust_delta: float = 2.0,
):
    """Distributed BA: observations sharded over the mesh, camera and point
    blocks replicated, one psum per segment reduction (SURVEY.md §2.7(d)).

    Observation count is padded to a mesh multiple with masked-out slots
    (zero Huber weight -> zero contribution), so the result is IDENTICAL to
    `run_ba` up to float reduction order.
    """
    from jax.sharding import PartitionSpec as P

    from densepoints.parallel.mesh import PATCH_AXIS

    n_dev = mesh.devices.size
    M = problem.obs_xy.shape[0]
    pad = (-M) % n_dev
    if pad:
        problem = dataclasses.replace(
            problem,
            obs_point=jnp.concatenate(
                [problem.obs_point, jnp.zeros((pad,), jnp.int32)]
            ),
            obs_view=jnp.concatenate(
                [problem.obs_view, jnp.zeros((pad,), jnp.int32)]
            ),
            obs_xy=jnp.concatenate(
                [problem.obs_xy, jnp.zeros((pad, 2), problem.obs_xy.dtype)]
            ),
            obs_mask=jnp.concatenate(
                [problem.obs_mask, jnp.zeros((pad,), bool)]
            ),
        )

    def local(K, R0, C0, points0, obs_point, obs_view, obs_xy, obs_mask):
        lp = BAProblem(
            K=K, R0=R0, C0=C0, points0=points0,
            obs_point=obs_point, obs_view=obs_view,
            obs_xy=obs_xy, obs_mask=obs_mask,
        )
        return _ba_core(
            lp, max_outer_iterations, cg_iterations, damping, robust_delta,
            reduce=functools.partial(jax.lax.psum, axis_name=PATCH_AXIS),
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(), P(), P(), P(),
            P(PATCH_AXIS), P(PATCH_AXIS), P(PATCH_AXIS), P(PATCH_AXIS),
        ),
        out_specs=(P(), P(), P(), P()),
    )(
        problem.K, problem.R0, problem.C0, problem.points0,
        problem.obs_point, problem.obs_view, problem.obs_xy,
        problem.obs_mask,
    )


def reprojection_rmse(problem: BAProblem, R, C, points) -> jax.Array:
    """Unrobustified RMS reprojection error in pixels over valid obs."""
    hi = jax.lax.Precision.HIGHEST  # pixel coords: never bf16
    cam = jnp.einsum(
        "mij,mj->mi",
        R[problem.obs_view],
        points[problem.obs_point] - C[problem.obs_view],
        precision=hi,
    )
    pix_h = jnp.einsum(
        "mij,mj->mi", problem.K[problem.obs_view], cam, precision=hi
    )
    pix = pix_h[:, :2] / pix_h[:, 2:3]
    err2 = jnp.sum((pix - problem.obs_xy) ** 2, -1)
    m = problem.obs_mask.astype(err2.dtype)
    return jnp.sqrt(jnp.sum(err2 * m) / jnp.maximum(jnp.sum(m), 1.0))
