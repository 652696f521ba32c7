"""BA-in-pipeline test: perturbed cameras are recovered before densification."""
import json

import numpy as np

from densepoints.config import (
    BAConfig,
    ExpandConfig,
    MatchingConfig,
    OptimizeConfig,
    PipelineConfig,
)
from densepoints.io import load_scene
from densepoints.pmvs.pipeline import densify
from tests.synthetic import TexturedPlaneScene


def test_ba_in_pipeline_fixes_perturbed_cameras(tmp_path, rng):
    from PIL import Image

    scene = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    imgdir = tmp_path / "images"
    imgdir.mkdir()
    views = []
    for v in range(5):
        img = scene.render(v).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(imgdir / f"v{v}.png")
        # Perturb the published projection matrices slightly (as if the SfM
        # input were noisy): small rotation of the P rows.
        P = scene.P[v].copy()
        if v > 0:
            ang = 0.002 * (1 if v % 2 else -1)
            Rz = np.array(
                [
                    [np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0],
                    [0, 0, 1],
                ]
            )
            P = P @ np.block(
                [[Rz, np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]]
            )
        views.append({"filename": f"v{v}.png", "projectionMatrix": P.tolist()})
    path = tmp_path / "scene.json"
    path.write_text(json.dumps({"imagesPath": str(imgdir), "views": views}))

    loaded = load_scene(path)
    base = PipelineConfig(
        matching=MatchingConfig(max_keypoints_per_view=256),
        optimize=OptimizeConfig(max_iterations=30),
        expand=ExpandConfig(max_rounds=1),
    )
    with_ba = base.replace(ba=BAConfig(enable=True, max_outer_iterations=12))
    result = densify(loaded, with_ba)
    assert "ba_rmse_px" in result.metrics.counters
    assert result.metrics.counters["ba_rmse_px"] < 1.0
    assert result.patches.capacity > 10
