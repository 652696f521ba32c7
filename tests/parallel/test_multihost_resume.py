"""Multihost checkpoint/resume: elastic mesh-size changes (SURVEY.md §5.3).

A job that loses hosts restarts with fewer devices and resumes from the
latest stage checkpoint; the sharded program is process-count agnostic, so
the resumed cloud must equal the uninterrupted one.
"""
import dataclasses

import numpy as np

from densepoints.config import PipelineConfig
from densepoints.core import Cameras
from densepoints.io.scene import Scene
from densepoints.parallel.mesh import make_mesh
from densepoints.parallel.multihost import densify_multihost
from tests.synthetic import TexturedPlaneScene


def _scene(rng):
    sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    cams = Cameras.from_projection_matrices(
        sc.P, widths=sc.width, heights=sc.height
    )
    scene = Scene(cameras=cams, images=sc.render_all(), colors=None)
    xy = rng.uniform(-0.6, 0.6, (40, 2))
    pts = np.concatenate([xy, np.zeros((40, 1))], 1).astype(np.float32)
    return scene, pts


def _cfg(**runtime):
    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg,
        expand=dataclasses.replace(cfg.expand, max_rounds=2),
        runtime=dataclasses.replace(cfg.runtime, **runtime),
    )
    return cfg


def test_resume_from_seeds_checkpoint_elastic_mesh(rng, tmp_path):
    scene, pts = _scene(rng)
    ckpt = str(tmp_path / "ckpt")

    # Uninterrupted run on 8 devices, checkpointing stages.
    full = densify_multihost(
        scene, _cfg(checkpoint_dir=ckpt), mesh=make_mesh(8), seed_points=pts
    )
    # "Host loss": restart on a 4-device mesh, resuming from the final
    # checkpoint — must short-circuit to the same cloud.
    resumed = densify_multihost(
        scene,
        _cfg(checkpoint_dir=ckpt, resume=True),
        mesh=make_mesh(4),
        seed_points=pts,
    )
    np.testing.assert_array_equal(
        np.asarray(resumed.patches.position), np.asarray(full.patches.position)
    )

    # Resume from the mid-run (seeds_optimized) checkpoint only: drop the
    # final checkpoint, re-run expansion on the smaller mesh.
    (tmp_path / "ckpt" / "final.npz").unlink()
    resumed2 = densify_multihost(
        scene,
        _cfg(checkpoint_dir=ckpt, resume=True),
        mesh=make_mesh(4),
        seed_points=pts,
    )
    np.testing.assert_allclose(
        np.asarray(resumed2.patches.position),
        np.asarray(full.patches.position),
        atol=1e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(resumed2.patches.vis), np.asarray(full.patches.vis)
    )
