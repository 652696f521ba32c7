"""Distributed end-to-end densify on the virtual 8-device mesh."""
import json

import numpy as np

from densepoints.config import (
    ExpandConfig,
    MatchingConfig,
    OptimizeConfig,
    PipelineConfig,
)
from densepoints.io import load_scene
from densepoints.parallel.pipeline import densify_distributed
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
    return path


def test_distributed_densify_end_to_end(tmp_path, rng):
    scene_path = _write_scene(tmp_path, rng)
    loaded = load_scene(scene_path)
    config = PipelineConfig(
        matching=MatchingConfig(max_keypoints_per_view=256),
        optimize=OptimizeConfig(max_iterations=30),
        expand=ExpandConfig(max_rounds=2),
    )
    result = densify_distributed(loaded, config)
    assert result.patches.capacity >= 30
    z = np.abs(result.positions[:, 2])
    assert np.median(z) < 0.05, np.median(z)
    assert "seed_refine_patches_per_sec" in result.metrics.counters
