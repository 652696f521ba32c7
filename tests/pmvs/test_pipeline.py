"""End-to-end densify() on the textured plane: scene JSON -> PLY.

This is the minimum end-to-end slice of SURVEY.md §7 step 7 / BASELINE.json
config 2 (full seed -> optimize -> expand -> filter loop on a toy scene).
"""
import dataclasses
import json

import numpy as np

from densepoints.config import (
    ExpandConfig,
    MatchingConfig,
    OptimizeConfig,
    PipelineConfig,
)
from densepoints.io import load_scene, read_ply
from densepoints.pmvs.pipeline import densify
from tests.synthetic import TexturedPlaneScene


def _write_scene(tmp_path, rng, num_views=5, width=160, height=120):
    from PIL import Image

    scene = TexturedPlaneScene(rng, num_views=num_views, width=width, height=height)
    imgdir = tmp_path / "images"
    imgdir.mkdir()
    views = []
    for v in range(num_views):
        img = scene.render(v).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(imgdir / f"view_{v}.png")
        views.append(
            {"filename": f"view_{v}.png", "projectionMatrix": scene.P[v].tolist()}
        )
    path = tmp_path / "scene.json"
    path.write_text(json.dumps({"imagesPath": str(imgdir), "views": views}))
    return path, scene


def _fast_config():
    return PipelineConfig(
        matching=MatchingConfig(max_keypoints_per_view=384),
        optimize=OptimizeConfig(max_iterations=40),
        expand=ExpandConfig(max_rounds=2),
    )


def test_densify_end_to_end(tmp_path, rng):
    scene_path, scene = _write_scene(tmp_path, rng)
    loaded = load_scene(scene_path)
    result = densify(loaded, _fast_config())
    assert result.patches.capacity >= 50, result.metrics.summary()
    z = np.abs(result.positions[:, 2])
    # The reconstruction is the z=0 plane.
    assert np.median(z) < 0.05, np.median(z)
    assert (z < 0.1).mean() > 0.7, (z < 0.1).mean()
    # Colors are sampled from the (grayscale replicated) images.
    assert result.colors.shape == (result.patches.capacity, 3)
    assert result.colors.max() > 0

    out = tmp_path / "cloud.ply"
    result.save_ply(out)
    cloud = read_ply(out)
    assert len(cloud["positions"]) == result.patches.capacity
    assert "normals" in cloud and "colors" in cloud


def test_cli_main(tmp_path, rng):
    from densepoints.cli import main

    scene_path, _ = _write_scene(tmp_path, rng, num_views=5)
    settings = tmp_path / "settings.json"
    settings.write_text(
        json.dumps(
            {
                "matching": {"max_keypoints_per_view": 256},
                "optimize": {"max_iterations": 30},
                "expand": {"max_rounds": 1},
            }
        )
    )
    out = tmp_path / "out.ply"
    rc = main(
        ["-i", str(scene_path), "-s", str(settings), "-o", str(out)]
    )
    assert rc == 0
    assert out.exists()
    cloud = read_ply(out)
    assert len(cloud["positions"]) > 10


def test_densify_checkpoint_resume_and_debug_dumps(tmp_path, rng):
    from densepoints.config import RuntimeConfig

    scene_path, scene = _write_scene(tmp_path, rng)
    loaded = load_scene(scene_path)
    ckpt_dir = tmp_path / "ckpt"
    dbg_dir = tmp_path / "dbg"
    config = dataclasses.replace(
        _fast_config(),
        runtime=RuntimeConfig(
            checkpoint_dir=str(ckpt_dir), debug_dir=str(dbg_dir)
        ),
    )
    result = densify(loaded, config)
    names = {p.name for p in ckpt_dir.glob("*.npz")}
    assert {"seeds_optimized.npz", "expanded.npz", "final.npz"} <= names
    dumped = list(dbg_dir.rglob("*"))
    assert any(p.suffix == ".ply" for p in dumped), dumped

    # Resume from the final checkpoint: only color reruns; the cloud must
    # match the original run's patch count.
    config_resume = dataclasses.replace(
        config,
        runtime=RuntimeConfig(checkpoint_dir=str(ckpt_dir), resume=True),
    )
    resumed = densify(loaded, config_resume)
    assert resumed.patches.capacity == result.patches.capacity
