"""Debug artifact dumps — the reference's DEBUG_PMVS_* outputs, first-party.

The reference's only integration "test" is visual (SURVEY.md §4): compile-
time flags dump keypoint overlays (matcher.cpp:69-79), match drawings,
triangulated clouds, patch textures (seed.cpp:158-212) and occupancy-grid
images (expand.cpp:145-168). Here the same artifacts are a runtime option:
`dump_*` functions write PNGs/PLYs under an output directory, callable from
any stage (and wired to `PipelineConfig` debug flags by the CLI).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = [
    "dump_keypoints",
    "dump_matches",
    "dump_occupancy",
    "dump_textures",
    "dump_cloud",
]


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)


def _save(path: Path, img: np.ndarray):
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(path)


def dump_keypoints(out_dir, images, xy, valid, radius: int = 2):
    """One grayscale PNG per view with keypoints marked (kp_<v>.png)."""
    out_dir = Path(out_dir)
    images = np.asarray(images)
    xy = np.asarray(xy)
    valid = np.asarray(valid)
    for v in range(images.shape[0]):
        rgb = np.stack([_to_u8(images[v])] * 3, -1)
        for x, y in xy[v][valid[v]].astype(int):
            y0, y1 = max(0, y - radius), min(rgb.shape[0], y + radius + 1)
            x0, x1 = max(0, x - radius), min(rgb.shape[1], x + radius + 1)
            rgb[y0:y1, x0:x1] = [255, 64, 64]
        _save(out_dir / f"kp_{v}.png", rgb)


def dump_matches(out_dir, images, xy, pairs, matches, max_lines: int = 200):
    """Side-by-side match drawings per pair (matches_<a>_<b>.png)."""
    out_dir = Path(out_dir)
    images = np.asarray(images)
    xy = np.asarray(xy)
    matches = np.asarray(matches)
    for p, (a, b) in enumerate(np.asarray(pairs)):
        ia, ib = _to_u8(images[a]), _to_u8(images[b])
        H = max(ia.shape[0], ib.shape[0])
        canvas = np.zeros((H, ia.shape[1] + ib.shape[1], 3), np.uint8)
        canvas[: ia.shape[0], : ia.shape[1]] = ia[..., None]
        canvas[: ib.shape[0], ia.shape[1] :] = ib[..., None]
        idx = np.nonzero(matches[p] >= 0)[0][:max_lines]
        for i in idx:
            x0, y0 = xy[a, i].astype(int)
            x1, y1 = xy[b, matches[p, i]].astype(int)
            x1 += ia.shape[1]
            n = max(abs(x1 - x0), abs(y1 - y0), 1)
            xs = np.linspace(x0, x1, n).astype(int)
            ys = np.linspace(y0, y1, n).astype(int)
            ok = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < canvas.shape[1])
            canvas[ys[ok], xs[ok]] = [64, 255, 64]
        _save(out_dir / f"matches_{a}_{b}.png", canvas)


def dump_occupancy(out_dir, grids):
    """Occupancy images per view like Expand::PrintPatchGrids (view_<v>.png)."""
    out_dir = Path(out_dir)
    cells = np.asarray(grids.cells)
    if cells.ndim == 4:  # K slots per cell: occupied = any slot filled
        cells = cells.max(axis=3)
    for v in range(cells.shape[0]):
        img = np.where(cells[v] >= 0, 255, 0).astype(np.uint8)
        _save(out_dir / f"view_{v}.png", img)


def dump_textures(out_dir, textures, valid, prefix: str = "tex", limit: int = 64):
    """Per-patch texture strips like Seed::PrintTextures."""
    out_dir = Path(out_dir)
    textures = np.asarray(textures)
    valid = np.asarray(valid)
    for b in range(min(limit, textures.shape[0])):
        strip = np.concatenate(list(_to_u8(textures[b])), axis=1)
        _save(out_dir / f"{prefix}_{b}.png", strip)


def dump_cloud(out_dir, name, state):
    """Intermediate patch cloud like PrintCloud (points/<name>.ply)."""
    from densepoints.io.ply import write_ply

    alive = np.asarray(state.alive)
    write_ply(
        Path(out_dir) / "points" / f"{name}.ply",
        np.asarray(state.position)[alive],
        np.asarray(state.normal)[alive],
        np.clip(np.asarray(state.color)[alive], 0, 255).astype(np.uint8),
    )
