"""Scene JSON reader tests (reference-compatible schema)."""
import json

import numpy as np
import pytest

from densepoints.io import load_scene, read_scene_json
from tests.synthetic import TexturedPlaneScene


def _write_scene(tmp_path, rng, num_views=3):
    from PIL import Image

    scene = TexturedPlaneScene(rng, num_views=num_views, width=64, height=48)
    imgdir = tmp_path / "images"
    imgdir.mkdir()
    views = []
    for v in range(num_views):
        img = scene.render(v).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(imgdir / f"view_{v}.png")
        views.append(
            {
                "filename": f"view_{v}.png",
                "projectionMatrix": scene.P[v].tolist(),
            }
        )
    spec = {"imagesPath": str(imgdir), "views": views}
    scene_path = tmp_path / "scene.json"
    scene_path.write_text(json.dumps(spec))
    return scene_path, scene


def test_read_scene_json(tmp_path, rng):
    path, scene = _write_scene(tmp_path, rng)
    spec = read_scene_json(path)
    assert len(spec.image_paths) == 3
    np.testing.assert_allclose(spec.projection_matrices, scene.P)


def test_load_scene(tmp_path, rng):
    path, scene = _write_scene(tmp_path, rng)
    loaded = load_scene(path)
    assert loaded.images.shape == (3, 48, 64)
    assert loaded.cameras.num_views == 3
    # Camera centers recovered from P match the generator's.
    np.testing.assert_allclose(np.asarray(loaded.cameras.C), scene.C, atol=1e-3)


def test_load_scene_drops_missing_images(tmp_path, rng):
    path, _ = _write_scene(tmp_path, rng)
    data = json.loads(path.read_text())
    data["views"].append(
        {"filename": "nonexistent.png", "projectionMatrix": data["views"][0]["projectionMatrix"]}
    )
    path.write_text(json.dumps(data))
    loaded = load_scene(path)
    assert loaded.cameras.num_views == 3  # missing view dropped (pmvs.cpp:15-19)


def test_bad_projection_matrix_raises(tmp_path):
    spec = {"imagesPath": ".", "views": [{"filename": "x.png", "projectionMatrix": [[1, 2], [3, 4]]}]}
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(spec))
    with pytest.raises(ValueError):
        read_scene_json(p)
