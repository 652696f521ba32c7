"""Debug artifact dump smoke tests."""
import numpy as np

from densepoints.pmvs.patch import PatchState
from densepoints.utils.debug import (
    dump_cloud,
    dump_keypoints,
    dump_matches,
    dump_occupancy,
    dump_textures,
)


def test_dump_keypoints_and_matches(tmp_path, rng):
    images = rng.uniform(0, 255, (2, 40, 60)).astype(np.float32)
    xy = rng.uniform(5, 35, (2, 10, 2)).astype(np.float32)
    valid = np.ones((2, 10), bool)
    dump_keypoints(tmp_path / "kp", images, xy, valid)
    assert (tmp_path / "kp" / "kp_0.png").exists()
    matches = np.full((1, 10), -1, np.int32)
    matches[0, :5] = np.arange(5)
    dump_matches(tmp_path / "m", images, xy, [[0, 1]], matches)
    assert (tmp_path / "m" / "matches_0_1.png").exists()


def test_dump_occupancy_and_cloud(tmp_path, rng):
    class G:
        cells = rng.integers(-1, 5, (2, 8, 10)).astype(np.int32)

    dump_occupancy(tmp_path / "occ", G)
    assert (tmp_path / "occ" / "view_1.png").exists()

    state = PatchState.create(
        rng.standard_normal((6, 3)).astype(np.float32),
        rng.standard_normal((6, 3)).astype(np.float32),
        np.zeros(6, np.int32),
        np.ones((6, 3), bool),
    )
    dump_cloud(tmp_path / "dbg", "after_expand", state)
    assert (tmp_path / "dbg" / "points" / "after_expand.ply").exists()


def test_dump_textures(tmp_path, rng):
    tex = rng.uniform(0, 255, (4, 3, 11, 11)).astype(np.float32)
    valid = np.ones((4, 3), bool)
    dump_textures(tmp_path / "tex", tex, valid)
    assert (tmp_path / "tex" / "tex_0.png").exists()
