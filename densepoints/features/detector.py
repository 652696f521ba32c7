"""Batched corner detection + grid filtering.

Reference parity: `Matcher::DetectKeypoints` (matcher.cpp:45-87, OpenCV ORB
with 40000 features) and `Matcher::FilterKeypoints` (matcher.cpp:89-153, the
PMVS uniform-coverage trick: bucket keypoints into a cell grid, keep the top
`max_keypoints_per_cell` responses per cell). Batched redesign: a Harris corner
response evaluated as a stencil over the whole image batch (separable
convolutions -> XLA fusion), then top-k per cell computed directly on the
response image by reshaping into (cells x cell-pixels) tiles — no
keypoint-list bucketing at all. Parity is at the reconstruction-metric level
(SURVEY.md §7), not per-keypoint.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "harris_response",
    "fast_response",
    "detect_keypoints",
    "gaussian_blur",
]


def _conv1d(img: jax.Array, kernel: jax.Array, axis: int) -> jax.Array:
    """1-D correlation along `axis` with edge replication, via slicing."""
    r = (kernel.shape[0] - 1) // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    x = jnp.pad(img, pad, mode="edge")
    n = img.shape[axis]
    out = jnp.zeros_like(img)
    for i in range(kernel.shape[0]):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + n)
        out = out + kernel[i] * x[tuple(sl)]
    return out


def gaussian_blur(img: jax.Array, sigma: float, radius: int | None = None):
    """Separable Gaussian blur over the trailing two axes."""
    if sigma <= 0:
        return img
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = jnp.arange(-radius, radius + 1, dtype=img.dtype)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    k = k / jnp.sum(k)
    return _conv1d(_conv1d(img, k, -1), k, -2)


# Plain tuples (NOT device arrays): creating arrays at import time would
# initialize the XLA backend and break jax.distributed.initialize ordering.
_SOBEL = (-1.0, 0.0, 1.0)
_SMOOTH = (0.25, 0.5, 0.25)


@functools.partial(jax.jit, static_argnames=("window_sigma",))
def harris_response(
    images: jax.Array, k: float = 0.04, window_sigma: float = 1.5
) -> jax.Array:
    """Harris corner response R = det(M) - k tr(M)^2 per pixel.

    images: (..., H, W) float; returns same shape.
    """
    img = images.astype(jnp.float32)
    gx = _conv1d(_conv1d(img, jnp.asarray(_SOBEL, img.dtype), -1), jnp.asarray(_SMOOTH, img.dtype), -2)
    gy = _conv1d(_conv1d(img, jnp.asarray(_SOBEL, img.dtype), -2), jnp.asarray(_SMOOTH, img.dtype), -1)
    ixx = gaussian_blur(gx * gx, window_sigma)
    iyy = gaussian_blur(gy * gy, window_sigma)
    ixy = gaussian_blur(gx * gy, window_sigma)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


# Bresenham circle of radius 3: the 16 (dy, dx) ring offsets of FAST-16,
# clockwise from 12 o'clock (the segment-test ring ORB's detector uses).
_FAST_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


@functools.partial(jax.jit, static_argnames=("threshold", "arc"))
def fast_response(
    images: jax.Array, threshold: float = 10.0, arc: int = 9
) -> jax.Array:
    """FAST segment-test corner response as a pure stencil.

    The reference's ORB front-end (matcher.cpp:45-87) is FAST-9/16 inside
    OpenCV; here the ring comparisons run as 16 shifted-slice ops over the
    whole image batch. A pixel is a corner when `arc` CONTIGUOUS ring pixels
    are all brighter (or all darker) than center +- threshold; its response
    is the summed margin over the brighter/darker set (a monotone stand-in
    for OpenCV's max-threshold score, used only for top-k ranking).
    Non-corners score -inf. images: (..., H, W) -> same shape.
    """
    img = images.astype(jnp.float32)
    H, W = img.shape[-2:]
    padded = jnp.pad(
        img, [(0, 0)] * (img.ndim - 2) + [(3, 3), (3, 3)], mode="edge"
    )
    diffs = []
    for dy, dx in _FAST_RING:
        nb = padded[..., 3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W]
        diffs.append(nb - img)
    diffs = jnp.stack(diffs)  # (16, ..., H, W)
    bright = diffs > threshold
    dark = diffs < -threshold
    # Contiguous-run test: OR over the 16 start positions of an AND over
    # `arc` consecutive ring pixels (indices mod 16).
    corner_b = jnp.zeros(img.shape, bool)
    corner_d = jnp.zeros(img.shape, bool)
    for s in range(16):
        run_b = bright[s]
        run_d = dark[s]
        for j in range(1, arc):
            run_b = run_b & bright[(s + j) % 16]
            run_d = run_d & dark[(s + j) % 16]
        corner_b = corner_b | run_b
        corner_d = corner_d | run_d
    score_b = jnp.sum(jnp.maximum(diffs - threshold, 0.0), axis=0)
    score_d = jnp.sum(jnp.maximum(-diffs - threshold, 0.0), axis=0)
    score = jnp.where(corner_b, score_b, 0.0) + jnp.where(corner_d, score_d, 0.0)
    return jnp.where(corner_b | corner_d, score, -jnp.inf)


def _nms3(resp: jax.Array) -> jax.Array:
    """3x3 non-maximum suppression mask (True where local max).

    Exact ties (common on synthetic imagery) break by raster order: the
    first pixel of a plateau wins (strict > against earlier neighbors,
    >= against later ones) — deterministic, no dropped plateaus.
    """
    r = jnp.pad(
        resp,
        [(0, 0)] * (resp.ndim - 2) + [(1, 1), (1, 1)],
        mode="constant",
        constant_values=-jnp.inf,
    )
    H, W = resp.shape[-2:]
    ok = jnp.ones(resp.shape, bool)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            nb = r[..., dy : dy + H, dx : dx + W]
            if (dy, dx) < (1, 1):
                ok = ok & (resp > nb)
            else:
                ok = ok & (resp >= nb)
    return ok


@functools.partial(
    jax.jit,
    static_argnames=(
        "cell_size", "max_per_cell", "max_keypoints", "border", "method",
        "fast_threshold",
    ),
)
def detect_keypoints(
    images: jax.Array,
    cell_size: int = 16,
    max_per_cell: int = 4,
    max_keypoints: int = 4096,
    k: float = 0.04,
    border: int = 8,
    method: str = "harris",
    fast_threshold: float = 10.0,
):
    """Detect grid-filtered corners for a batch of images.

    `method` selects the response: "harris" (stencil Harris) or "fast"
    (FAST-9/16 segment test) — the analog of the reference's ORB | AKAZE
    detector switch (matcher.h:17). images: (V, H, W) float. Returns
    (xy (V, N, 2) float32, response (V, N) float32, valid (V, N) bool) with
    N = max_keypoints. Keypoints are the per-cell top `max_per_cell` local
    maxima, then the global top N by response (the same two-stage selection
    as the reference's ORB-40000 -> grid top-4 pipeline, fused).
    """
    V, H, W = images.shape
    if method == "harris":
        resp = harris_response(images, k=k)
    elif method == "fast":
        resp = fast_response(images, threshold=fast_threshold)
    else:
        raise ValueError(f"unknown detector {method!r}")
    is_max = _nms3(resp)
    # Suppress borders (descriptor sampling window must fit).
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    in_border = (
        (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    )
    resp = jnp.where(is_max & in_border, resp, -jnp.inf)

    # Pad to multiples of cell_size, reshape to cells.
    Hp = -(-H // cell_size) * cell_size
    Wp = -(-W // cell_size) * cell_size
    resp_p = jnp.pad(
        resp,
        [(0, 0), (0, Hp - H), (0, Wp - W)],
        mode="constant",
        constant_values=-jnp.inf,
    )
    hc, wc = Hp // cell_size, Wp // cell_size
    cells = resp_p.reshape(V, hc, cell_size, wc, cell_size)
    cells = cells.transpose(0, 1, 3, 2, 4).reshape(V, hc * wc, cell_size * cell_size)
    top_vals, top_idx = jax.lax.top_k(cells, max_per_cell)  # (V, C, m)

    # Convert per-cell indices to absolute pixel coordinates.
    cell_ids = jnp.arange(hc * wc)
    cy = (cell_ids // wc)[None, :, None]
    cx = (cell_ids % wc)[None, :, None]
    py = cy * cell_size + top_idx // cell_size
    px = cx * cell_size + top_idx % cell_size

    flat_vals = top_vals.reshape(V, -1)
    flat_x = px.reshape(V, -1)
    flat_y = py.reshape(V, -1)
    n_cand = flat_vals.shape[1]
    n_keep = min(max_keypoints, n_cand)
    sel_vals, sel = jax.lax.top_k(flat_vals, n_keep)
    xy = jnp.stack(
        [
            jnp.take_along_axis(flat_x, sel, axis=1),
            jnp.take_along_axis(flat_y, sel, axis=1),
        ],
        axis=-1,
    ).astype(jnp.float32)
    valid = jnp.isfinite(sel_vals) & (sel_vals > 0)
    if n_keep < max_keypoints:
        pad = max_keypoints - n_keep
        xy = jnp.pad(xy, [(0, 0), (0, pad), (0, 0)])
        sel_vals = jnp.pad(sel_vals, [(0, 0), (0, pad)])
        valid = jnp.pad(valid, [(0, 0), (0, pad)])
    return xy, sel_vals, valid
