"""Metrics and checkpoint tests."""
import numpy as np

from densepoints.pmvs.patch import PatchState
from densepoints.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from densepoints.utils.metrics import accuracy_completeness


def test_metrics_identical_clouds(rng):
    cloud = rng.standard_normal((500, 3))
    m = accuracy_completeness(cloud, cloud)
    assert m.accuracy_mean == 0.0 and m.completeness_median == 0.0
    assert m.accuracy_frac_under == 1.0


def test_metrics_shifted_cloud(rng):
    gt = rng.standard_normal((1000, 3))
    cloud = gt + np.array([0.05, 0.0, 0.0])
    m = accuracy_completeness(cloud, gt, threshold=0.1)
    assert 0.0 < m.accuracy_median <= 0.051
    assert m.accuracy_frac_under > 0.9


def test_metrics_incomplete_cloud(rng):
    gt = rng.uniform(-1, 1, (2000, 3))
    half = gt[gt[:, 0] < 0]  # reconstruct only half the space
    m = accuracy_completeness(half, gt, threshold=0.05)
    assert m.accuracy_median < 1e-9  # every produced point is correct
    assert m.completeness_median > 1e-3  # but half the surface is missing


def test_checkpoint_roundtrip(tmp_path, rng):
    P, V = 37, 5
    state = PatchState.create(
        rng.standard_normal((P, 3)).astype(np.float32),
        rng.standard_normal((P, 3)).astype(np.float32),
        rng.integers(0, V, P).astype(np.int32),
        rng.uniform(size=(P, V)) > 0.5,
    )
    path = tmp_path / "ckpt" / "stage_expand.npz"
    save_checkpoint(path, state, "expand", {"round": 3})
    loaded, meta, cams = load_checkpoint(path)
    assert meta["stage"] == "expand" and meta["round"] == 3
    assert cams is None  # no cameras were saved
    np.testing.assert_allclose(
        np.asarray(loaded.position), np.asarray(state.position)
    )
    np.testing.assert_array_equal(
        np.asarray(loaded.vis), np.asarray(state.vis)
    )
    assert latest_checkpoint(tmp_path / "ckpt") == path
    assert latest_checkpoint(tmp_path / "nonexistent") is None


def test_checkpoint_carries_cameras(tmp_path, rng):
    """BA-refined extrinsics round-trip through the checkpoint (so resume
    reconstructs with the geometry the patches were optimized against)."""
    from densepoints.core.cameras import Cameras
    from tests.synthetic import TexturedPlaneScene

    scene = TexturedPlaneScene(rng, num_views=3, width=64, height=48)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    state = PatchState.create(
        rng.standard_normal((4, 3)).astype(np.float32),
        rng.standard_normal((4, 3)).astype(np.float32),
        np.zeros(4, np.int32),
        np.ones((4, 3), bool),
    )
    path = tmp_path / "final.npz"
    save_checkpoint(path, state, "final", cameras=cams)
    _, _, loaded_cams = load_checkpoint(path)
    assert loaded_cams is not None
    np.testing.assert_allclose(
        np.asarray(loaded_cams.C), np.asarray(cams.C), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(loaded_cams.K), np.asarray(cams.K), rtol=1e-5, atol=1e-4
    )
