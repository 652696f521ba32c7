"""Determinism: same seed -> same cloud (SURVEY.md §5.2).

The reference's OpenMP queue made contested-cell outcomes depend on thread
scheduling; the batched redesign resolves all contention by global candidate
ids, so two identical runs must agree BYTE-FOR-BYTE — on one device and on
the 8-device mesh (cross-process agreement is covered by
tests/parallel/test_multihost.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np

from densepoints.config import PipelineConfig
from densepoints.core import Cameras
from densepoints.io.scene import Scene
from densepoints.pmvs.expand import expand_patches
from densepoints.pmvs.patch import PatchState
from tests.synthetic import TexturedPlaneScene


def _scene_and_seeds(seed: int):
    rng = np.random.default_rng(seed)
    sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    cams = Cameras.from_projection_matrices(
        sc.P, widths=sc.width, heights=sc.height
    )
    images = jnp.asarray(sc.render_all())
    xy = rng.uniform(-0.6, 0.6, (32, 2))
    pts = np.concatenate([xy, np.zeros((32, 1))], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (32, 1)).astype(np.float32)
    vis = np.ones((32, 5), bool)
    vis[:, 0] = False
    state = PatchState.create(pts, normal, np.zeros(32, np.int32), vis)
    return cams, images, state, pts


def _cloud_single(seed: int):
    cams, images, state, _ = _scene_and_seeds(seed)
    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, expand=dataclasses.replace(cfg.expand, max_rounds=2)
    )
    final, _ = expand_patches(
        images, cams, state, cfg.expand, cfg.organizer, cfg.optimize
    )
    return np.asarray(final.position), np.asarray(final.vis)


def _cloud_mesh(seed: int):
    from densepoints.parallel.multihost import densify_multihost

    cams, images, state, pts = _scene_and_seeds(seed)
    scene = Scene(cameras=cams, images=np.asarray(images), colors=None)
    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, expand=dataclasses.replace(cfg.expand, max_rounds=2)
    )
    res = densify_multihost(scene, cfg, seed_points=pts)
    return np.asarray(res.patches.position), np.asarray(res.patches.vis)


def test_single_device_runs_identical():
    p1, v1 = _cloud_single(7)
    p2, v2 = _cloud_single(7)
    assert p1.shape == p2.shape and p1.shape[0] > 0
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(v1, v2)


def test_mesh_runs_identical():
    p1, v1 = _cloud_mesh(7)
    p2, v2 = _cloud_mesh(7)
    assert p1.shape == p2.shape and p1.shape[0] > 0
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(v1, v2)
