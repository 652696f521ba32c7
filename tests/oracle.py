"""Float64 numpy oracle for the all-views anchor-NCC score grid.

Shares no JAX code with the implementations it checks (ops/allview.py):
projection, bilinear sampling and NCC are written out in numpy float64.
`scan_scale_case` builds the scan-scale scene both the CPU tests and
`chip_smoke.py` score: 4 views at 1600x1200, focal 2900, a 2048-px
texture and 64 patches spread +-60 mm, where pixel coordinates are large
enough that reduced-precision geometry (bf16 or TF32 matmuls) moves
window corners by whole pixels.
"""
from __future__ import annotations

import numpy as np

from densepoints.core.scores import NCC_MIN_DENOM


def scan_scale_case(rng: np.random.Generator, num_patches: int = 64):
    """(cameras, images (V, H, W) f32, position, normal, refs, vis)."""
    from densepoints.core import Cameras
    from tests.synthetic import TexturedPlaneScene

    scene = TexturedPlaneScene(
        rng, num_views=4, width=1600, height=1200, focal=2900.0,
        radius=600.0, plane_half_extent=170.0, tex_size=2048,
    )
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    images = scene.render_all().astype(np.float32)
    B = num_patches
    xy = rng.uniform(-60.0, 60.0, (B, 2))  # wide spread: large pixel coords
    position = np.concatenate([xy, np.zeros((B, 1))], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (B, 1)).astype(np.float32)
    refs = np.zeros((B,), np.int32)
    vis = np.ones((B, cams.num_views), bool)
    vis[:, 0] = False
    return cams, images, position, normal, refs, vis


def allview_scores_numpy(cams, images, position, normal, refs, vis, k):
    """(B, V) float64 anchor-NCC grid with allview_scores_* semantics."""
    K = np.asarray(cams.K, np.float64)
    E = np.asarray(cams.E, np.float64)
    C = np.asarray(cams.C, np.float64)
    x_axis = np.asarray(cams.x_axis, np.float64)
    images = np.asarray(images)
    V, H, W = images.shape
    pos64 = np.asarray(position, np.float64)
    nrm64 = np.asarray(normal, np.float64)
    refs = np.asarray(refs)
    vis = np.asarray(vis)
    B = pos64.shape[0]

    def project(pts):  # (..., 3) -> (V, ..., 2) pixel coords
        rel = pts[None, ...] - C.reshape((V,) + (1,) * (pts.ndim - 1) + (3,))
        cam = np.einsum("vij,v...j->v...i", E[:, :, :3], rel)
        pix = np.einsum("vij,v...j->v...i", K, cam)
        return pix[..., :2] / pix[..., 2:3]

    xa = x_axis[refs]
    ya = np.cross(nrm64, xa)
    bidx = np.arange(B)
    p0 = project(pos64)[refs, bidx]
    p1 = project(pos64 + xa)[refs, bidx]
    dx = np.linalg.norm(p1 - p0, axis=-1)
    scale = (k // 2) / np.maximum(dx, 1e-12)
    sx = scale[:, None] * xa
    sy = scale[:, None] * ya

    coords = (2.0 * np.arange(k) / k) - 1.0
    tt, ss = np.meshgrid(coords, coords, indexing="ij")
    world = (
        pos64[:, None, None, :]
        + ss[None, :, :, None] * sx[:, None, None, :]
        + tt[None, :, :, None] * sy[:, None, None, :]
    )  # (B, k, k, 3)
    corners = pos64[:, None, :] + np.stack(
        [-sx - sy, sx - sy, sx + sy, -sx + sy], axis=1
    )
    pix_w = project(world)  # (V, B, k, k, 2)
    pix_c = project(corners)  # (V, B, 4, 2)
    w = np.asarray(cams.width, np.float64)[:, None, None]
    h = np.asarray(cams.height, np.float64)[:, None, None]
    inside = (
        (pix_c[..., 0] > 0) & (pix_c[..., 0] < w)
        & (pix_c[..., 1] > 0) & (pix_c[..., 1] < h)
    )
    valid = np.all(inside, axis=-1).T & vis  # (B, V)

    def bilinear(img, xyv):  # clamp-to-edge, matching ops/warp.py
        x = np.clip(xyv[..., 0], 0.0, W - 1.0)
        y = np.clip(xyv[..., 1], 0.0, H - 1.0)
        x0 = np.clip(np.floor(x).astype(int), 0, W - 2)
        y0 = np.clip(np.floor(y).astype(int), 0, H - 2)
        fx, fy = x - x0, y - y0
        im = img.astype(np.float64)
        return (
            im[y0, x0] * (1 - fx) * (1 - fy)
            + im[y0, x0 + 1] * fx * (1 - fy)
            + im[y0 + 1, x0] * (1 - fx) * fy
            + im[y0 + 1, x0 + 1] * fx * fy
        )

    tex = np.stack([bilinear(images[v], pix_w[v]) for v in range(V)], 1)
    flat = tex.reshape(B, V, k * k)
    n = float(k * k)
    anchor = np.argmax(vis, axis=1)
    a = flat[bidx, anchor]
    a_ok = valid[bidx, anchor] & vis.any(axis=1)
    ac = a - a.mean(axis=1, keepdims=True)
    sa = np.sqrt(np.sum(ac * ac, axis=1) / n)
    ct = flat - flat.mean(axis=2, keepdims=True)
    st = np.sqrt(np.sum(ct * ct, axis=2) / n)
    cov = np.sum(ct * ac[:, None, :], axis=2) / n
    den = np.maximum(sa[:, None] * st, NCC_MIN_DENOM)
    payload = vis & (np.arange(V)[None, :] != anchor[:, None])
    return np.where(payload & valid & a_ok[:, None], cov / den, -1.0)


def compare_to_oracle(got, want, tol):
    """Agreement statistics of a score grid against the oracle.

    Returns dict: scored slots, max/mean |dNCC| over them, the sentinel
    pattern match, and the accept-decision agreement at 0.6 over slots
    further than `tol` from the threshold (decisive ones).
    """
    got = np.asarray(got, np.float64)
    scored = want > -1.0
    diff = np.abs(got - want)[scored]
    decisive = scored & (np.abs(want - 0.6) > tol)
    agree = (got >= 0.6)[decisive] == (want >= 0.6)[decisive]
    return {
        "scored": int(scored.sum()),
        "max_abs": float(diff.max()) if diff.size else 0.0,
        "mean_abs": float(diff.mean()) if diff.size else 0.0,
        "sentinels_match": bool(np.array_equal(got <= -1.0, ~scored)),
        "decisive": int(decisive.sum()),
        "accept_agreement": float(agree.mean()) if agree.size else 1.0,
    }
