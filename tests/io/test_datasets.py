"""Dataset adapters: DTU calibration + COLMAP text model -> scene JSON."""
import numpy as np
from PIL import Image

from densepoints.io.datasets import colmap_to_scene_json, dtu_to_scene_json
from densepoints.io.scene import load_scene
from tests.synthetic import TexturedPlaneScene


def _write_images(scene, images_dir, namer):
    images_dir.mkdir(parents=True, exist_ok=True)
    imgs = scene.render_all()
    for i in range(imgs.shape[0]):
        Image.fromarray(
            np.clip(imgs[i], 0, 255).astype(np.uint8)
        ).save(images_dir / namer(i))


def test_dtu_adapter_roundtrip(tmp_path, rng):
    scene = TexturedPlaneScene(rng, num_views=4, width=64, height=48)
    calib = tmp_path / "Calibration"
    calib.mkdir()
    # DTU is 1-indexed; matrices one row per line.
    for i in range(4):
        np.savetxt(calib / f"pos_{i + 1:03d}.txt", scene.P[i])
    _write_images(
        scene, tmp_path / "Rectified",
        lambda i: f"rect_{i + 1:03d}_max_r5000.png",
    )
    out = dtu_to_scene_json(
        calib, tmp_path / "Rectified", tmp_path / "scene.json"
    )
    loaded = load_scene(out)
    assert loaded.cameras.num_views == 4
    np.testing.assert_allclose(
        np.asarray(loaded.cameras.P), scene.P, rtol=1e-5, atol=1e-4
    )


def test_dtu_adapter_skips_missing_images(tmp_path, rng):
    scene = TexturedPlaneScene(rng, num_views=3, width=64, height=48)
    calib = tmp_path / "cal"
    calib.mkdir()
    for i in range(3):
        np.savetxt(calib / f"pos_{i + 1:03d}.txt", scene.P[i])
    _write_images(
        scene, tmp_path / "img", lambda i: f"rect_{i + 1:03d}_max.png"
    )
    (tmp_path / "img" / "rect_002_max.png").unlink()  # view 2 unloadable
    out = dtu_to_scene_json(calib, tmp_path / "img", tmp_path / "s.json")
    loaded = load_scene(out)
    assert loaded.cameras.num_views == 2  # pmvs.cpp:15-19 drop semantics


def test_colmap_radial_single_focal_and_numeric_names(tmp_path, rng):
    """RADIAL params are f,cx,cy,k1,k2 (single focal), and numeric-looking
    filenames must not be mistaken for POINTS2D lines (ADVICE r2)."""
    scene = TexturedPlaneScene(rng, num_views=2, width=64, height=48)
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    K = scene.K
    assert K[0, 0] == K[1, 1]  # single focal in the fixture
    with open(sparse / "cameras.txt", "w") as f:
        f.write(
            f"1 RADIAL 64 48 {K[0, 0]} {K[0, 2]} {K[1, 2]} 0.001 0.0001\n"
        )
    with open(sparse / "images.txt", "w") as f:
        for i in range(2):
            M = np.linalg.inv(K) @ scene.P[i]
            R, t = M[:, :3], M[:, 3]
            w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
            x = (R[2, 1] - R[1, 2]) / (4 * w)
            y = (R[0, 2] - R[2, 0]) / (4 * w)
            z = (R[1, 0] - R[0, 1]) / (4 * w)
            # Filename "1e5.png"... without extension parses as a float.
            f.write(
                f"{i + 1} {w} {x} {y} {z} {t[0]} {t[1]} {t[2]} 1 1e{i}\n"
            )
            f.write("1.0 2.0 3\n")  # non-empty POINTS2D line
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    imgs = scene.render_all()
    for i in range(2):  # extension-less name -> explicit format
        Image.fromarray(
            np.clip(imgs[i], 0, 255).astype(np.uint8)
        ).save(img_dir / f"1e{i}", format="PNG")
    out = colmap_to_scene_json(sparse, img_dir, tmp_path / "s.json")
    loaded = load_scene(out)
    assert loaded.cameras.num_views == 2
    pt = np.array([0.1, -0.2, 0.05, 1.0])
    for i in range(2):
        want = scene.P[i] @ pt
        got = np.asarray(loaded.cameras.P)[i] @ pt
        np.testing.assert_allclose(
            got[:2] / got[2], want[:2] / want[2], atol=1e-3
        )


def test_colmap_adapter_roundtrip(tmp_path, rng):
    scene = TexturedPlaneScene(rng, num_views=3, width=64, height=48)
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    K = scene.K
    with open(sparse / "cameras.txt", "w") as f:
        f.write("# comment line\n")
        f.write(
            f"1 PINHOLE 64 48 {K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]}\n"
        )
    with open(sparse / "images.txt", "w") as f:
        f.write("# images\n")
        for i in range(3):
            # Decompose P = K [R | t] back into quaternion + translation.
            M = np.linalg.inv(K) @ scene.P[i]
            R, t = M[:, :3], M[:, 3]
            # rotmat -> qvec (w, x, y, z)
            w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
            x = (R[2, 1] - R[1, 2]) / (4 * w)
            y = (R[0, 2] - R[2, 0]) / (4 * w)
            z = (R[1, 0] - R[0, 1]) / (4 * w)
            f.write(
                f"{i + 1} {w} {x} {y} {z} {t[0]} {t[1]} {t[2]} 1 v{i}.png\n"
            )
            f.write("\n")  # POINTS2D line (empty)
    _write_images(scene, tmp_path / "img", lambda i: f"v{i}.png")
    out = colmap_to_scene_json(sparse, tmp_path / "img", tmp_path / "s.json")
    loaded = load_scene(out)
    assert loaded.cameras.num_views == 3
    # Projection parity: project a world point with both camera sets.
    pt = np.array([0.1, -0.2, 0.05, 1.0])
    for i in range(3):
        want = scene.P[i] @ pt
        got = np.asarray(loaded.cameras.P)[i] @ pt
        np.testing.assert_allclose(
            got[:2] / got[2], want[:2] / want[2], atol=1e-3
        )


def test_colmap_binary_model_roundtrip(tmp_path, rng):
    """cameras.bin / images.bin (COLMAP's default export) parse to the same
    scene as the text model."""
    import struct

    scene = TexturedPlaneScene(rng, num_views=3, width=64, height=48)
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    K = scene.K
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        # PINHOLE (model_id 1): fx fy cx cy
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48))
        f.write(struct.pack("<4d", K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 3))
        for i in range(3):
            M = np.linalg.inv(K) @ scene.P[i]
            R, t = M[:, :3], M[:, 3]
            w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
            x = (R[2, 1] - R[1, 2]) / (4 * w)
            y = (R[0, 2] - R[2, 0]) / (4 * w)
            z = (R[1, 0] - R[0, 1]) / (4 * w)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", w, x, y, z))
            f.write(struct.pack("<3d", *t))
            f.write(struct.pack("<i", 1))
            f.write(f"v{i}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))  # two POINTS2D entries to skip
            f.write(struct.pack("<ddq", 1.0, 2.0, -1) * 2)
    _write_images(scene, tmp_path / "img", lambda i: f"v{i}.png")
    out = colmap_to_scene_json(sparse, tmp_path / "img", tmp_path / "s.json")
    loaded = load_scene(out)
    assert loaded.cameras.num_views == 3
    pt = np.array([0.1, -0.2, 0.05, 1.0])
    for i in range(3):
        want = scene.P[i] @ pt
        got = np.asarray(loaded.cameras.P)[i] @ pt
        np.testing.assert_allclose(
            got[:2] / got[2], want[:2] / want[2], atol=1e-3
        )
