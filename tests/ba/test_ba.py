"""Bundle adjustment recovery tests on synthetic scenes."""
import jax.numpy as jnp
import numpy as np

from densepoints.ba import BAProblem, reprojection_rmse, rodrigues, run_ba
from tests.synthetic import TexturedPlaneScene


def test_rodrigues_identity_and_known_rotation():
    R0 = np.asarray(rodrigues(jnp.zeros(3)))
    np.testing.assert_allclose(R0, np.eye(3), atol=1e-6)
    Rz = np.asarray(rodrigues(jnp.asarray([0.0, 0.0, np.pi / 2])))
    np.testing.assert_allclose(
        Rz @ np.array([1.0, 0, 0]), [0, 1, 0], atol=1e-6
    )


def _make_problem(rng, num_views=6, num_points=120, noise_px=0.0,
                  cam_rot_pert=0.0, cam_trans_pert=0.0, point_pert=0.0):
    scene = TexturedPlaneScene(rng, num_views=num_views, width=640, height=480,
                               focal=500.0)
    # True structure: random points on and around the plane.
    pts = np.concatenate(
        [rng.uniform(-1.5, 1.5, (num_points, 2)),
         rng.uniform(-0.2, 0.2, (num_points, 1))], axis=1
    )
    K = np.stack([scene.K] * num_views)
    R_true = np.zeros((num_views, 3, 3))
    C_true = scene.C.copy()
    for v in range(num_views):
        M = scene.P[v][:, :3]
        R_true[v] = np.linalg.inv(scene.K) @ M
    obs_p, obs_v, obs_xy = [], [], []
    for v in range(num_views):
        cam = (R_true[v] @ (pts - C_true[v]).T).T
        pix = (scene.K @ cam.T).T
        pix = pix[:, :2] / pix[:, 2:]
        for p in range(num_points):
            obs_p.append(p)
            obs_v.append(v)
            obs_xy.append(pix[p] + rng.normal(0, noise_px, 2))
    # Perturb initial cameras/points.
    R0 = np.zeros_like(R_true)
    C0 = C_true + rng.normal(0, cam_trans_pert, C_true.shape)
    for v in range(num_views):
        w = rng.normal(0, cam_rot_pert, 3)
        R0[v] = R_true[v] @ np.asarray(rodrigues(jnp.asarray(w)))
    # Keep view 0 anchored (gauge): no perturbation.
    R0[0], C0[0] = R_true[0], C_true[0]
    pts0 = pts + rng.normal(0, point_pert, pts.shape)
    problem = BAProblem(
        K=jnp.asarray(K, jnp.float32),
        R0=jnp.asarray(R0, jnp.float32),
        C0=jnp.asarray(C0, jnp.float32),
        points0=jnp.asarray(pts0, jnp.float32),
        obs_point=jnp.asarray(obs_p, jnp.int32),
        obs_view=jnp.asarray(obs_v, jnp.int32),
        obs_xy=jnp.asarray(np.stack(obs_xy), jnp.float32),
        obs_mask=jnp.ones((len(obs_p),), bool),
    )
    return problem, R_true, C_true, pts


def test_ba_noise_free_perturbation_recovery(rng):
    problem, R_true, C_true, pts = _make_problem(
        rng, cam_rot_pert=0.01, cam_trans_pert=0.05, point_pert=0.05
    )
    rmse0 = float(
        reprojection_rmse(problem, problem.R0, problem.C0, problem.points0)
    )
    R, C, points, cost = run_ba(problem, max_outer_iterations=15)
    rmse = float(reprojection_rmse(problem, R, C, points))
    assert rmse0 > 1.0, rmse0  # perturbation was meaningful
    assert rmse < 0.1, (rmse0, rmse)


def test_ba_with_noise_converges_to_noise_floor(rng):
    problem, *_ = _make_problem(
        rng, noise_px=0.5, cam_rot_pert=0.005, cam_trans_pert=0.02,
        point_pert=0.02
    )
    R, C, points, cost = run_ba(problem, max_outer_iterations=15)
    rmse = float(reprojection_rmse(problem, R, C, points))
    # 0.5 px observation noise -> optimum near the noise floor.
    assert rmse < 1.0, rmse


def test_ba_masked_observations_ignored(rng):
    problem, *_ = _make_problem(rng, cam_rot_pert=0.005, cam_trans_pert=0.02)
    # Corrupt a random 20% of observations but mask them off (a prefix
    # would deprive whole views of constraints and change the gauge).
    M = problem.obs_xy.shape[0]
    bad = rng.permutation(M)[: M // 5]
    bad_xy = np.asarray(problem.obs_xy).copy()
    bad_xy[bad] += 300.0
    mask = np.ones((M,), bool)
    mask[bad] = False
    import dataclasses

    problem2 = dataclasses.replace(
        problem,
        obs_xy=jnp.asarray(bad_xy),
        obs_mask=jnp.asarray(mask),
    )
    R, C, points, _ = run_ba(problem2, max_outer_iterations=15)
    rmse = float(reprojection_rmse(problem, R, C, points))  # vs clean obs
    assert rmse < 0.2, rmse


def test_sharded_ba_matches_single_device(rng):
    """Observation-sharded BA (one psum per segment reduction) must produce
    the same camera/point updates as the single-device solver."""
    from densepoints.ba import run_ba, run_ba_sharded
    from densepoints.parallel import make_mesh

    problem, _, _, _ = _make_problem(
        rng, noise_px=0.3, cam_rot_pert=0.01, cam_trans_pert=0.05,
        point_pert=0.05,
    )
    R1, C1, X1, c1 = run_ba(
        problem, max_outer_iterations=4, cg_iterations=25
    )
    mesh = make_mesh()
    R2, C2, X2, c2 = run_ba_sharded(
        problem, mesh, max_outer_iterations=4, cg_iterations=25
    )
    # f32 psum reduction order differs from the single-device segment_sum;
    # 4 LM iterations amplify that to ~3e-5 — the solutions are the same.
    np.testing.assert_allclose(
        np.asarray(R2), np.asarray(R1), atol=2e-4, rtol=0
    )
    np.testing.assert_allclose(
        np.asarray(C2), np.asarray(C1), atol=2e-4, rtol=0
    )
    np.testing.assert_allclose(
        np.asarray(X2), np.asarray(X1), atol=5e-4, rtol=0
    )
    assert abs(float(c1) - float(c2)) < 1e-4
