"""Reconstruction-quality benchmark on curved geometry (sphere scene).

BASELINE.md north star is DTU-style accuracy/completeness; this is the
hermetic stand-in: reconstruct a textured unit sphere from 5 views and
measure cloud-vs-ground-truth distances with the DTU protocol metrics.
"""
import json

import numpy as np

from densepoints.config import (
    ExpandConfig,
    MatchingConfig,
    OptimizeConfig,
    PipelineConfig,
)
from densepoints.io import load_scene
from densepoints.pmvs.pipeline import densify
from densepoints.utils.metrics import accuracy_completeness
from tests.synthetic import TexturedSphereScene


def test_sphere_reconstruction_quality(tmp_path, rng):
    from PIL import Image

    scene = TexturedSphereScene(rng, num_views=5, width=200, height=160)
    imgdir = tmp_path / "images"
    imgdir.mkdir()
    views = []
    for v in range(5):
        img = scene.render(v).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(imgdir / f"v{v}.png")
        views.append(
            {"filename": f"v{v}.png", "projectionMatrix": scene.P[v].tolist()}
        )
    path = tmp_path / "scene.json"
    path.write_text(json.dumps({"imagesPath": str(imgdir), "views": views}))

    loaded = load_scene(path)
    config = PipelineConfig(
        matching=MatchingConfig(max_keypoints_per_view=384),
        optimize=OptimizeConfig(max_iterations=40),
        expand=ExpandConfig(max_rounds=4),
    )
    result = densify(loaded, config)
    assert result.patches.capacity >= 40, result.metrics.summary()

    gt = scene.sample_surface(rng, 4000)
    m = accuracy_completeness(result.positions, gt, threshold=0.05)
    # Pixel footprint at the sphere is ~0.017 world units; demand median
    # accuracy within ~2 footprints. Completeness stays loose: the GT cap
    # is much larger than the few-hundred-patch reconstruction.
    assert m.accuracy_median < 0.04, m.summary()
    assert m.accuracy_frac_under > 0.6, m.summary()
    assert m.completeness_median < 0.5, m.summary()

    # Normals approximately radial (outward or inward alignment counts --
    # the PMVS convention points away from the reference camera).
    pos = result.positions
    radial = pos / np.maximum(np.linalg.norm(pos, axis=1, keepdims=True), 1e-9)
    align = np.abs(np.sum(result.normals * radial, axis=1))
    assert np.median(align) > 0.75, np.median(align)
