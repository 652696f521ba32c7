"""Harris detection + grid filter tests."""
import jax.numpy as jnp
import numpy as np

from densepoints.features import detect_keypoints, harris_response


def _checkerboard(h, w, sq=8):
    ys, xs = np.mgrid[0:h, 0:w]
    return (((ys // sq) + (xs // sq)) % 2 * 255.0).astype(np.float32)


def test_harris_peaks_at_corners():
    img = _checkerboard(64, 64, sq=16)
    resp = np.asarray(harris_response(jnp.asarray(img[None])))[0]
    # Corner pixels (grid crossings away from the border) must outscore
    # edge midpoints and flat regions.
    corner = resp[16 - 1 : 16 + 2, 16 - 1 : 16 + 2].max()
    edge = resp[16, 8]  # middle of a square edge
    flat = resp[8, 8]  # deep inside a square
    assert corner > 0, corner
    assert edge < 0, edge  # Harris is negative on pure edges
    assert abs(flat) < corner * 1e-3, (corner, flat)


def test_detect_keypoints_finds_crossings():
    img = _checkerboard(96, 96)
    xy, resp, valid = detect_keypoints(
        jnp.asarray(img[None]), cell_size=16, max_per_cell=4, max_keypoints=256
    )
    got = np.asarray(xy)[0][np.asarray(valid)[0]]
    assert len(got) >= 20
    # Every detected keypoint should be within 2 px of a grid crossing.
    offs = got % 8
    dist = np.minimum(offs, 8 - offs)
    assert np.all(dist <= 2), got[:10]


def test_grid_filter_limits_per_cell():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (64, 64)).astype(np.float32)
    xy, resp, valid = detect_keypoints(
        jnp.asarray(img[None]), cell_size=16, max_per_cell=2, max_keypoints=512
    )
    got = np.asarray(xy)[0][np.asarray(valid)[0]].astype(int)
    cells = {}
    for x, y in got:
        cells.setdefault((x // 16, y // 16), 0)
        cells[(x // 16, y // 16)] += 1
    assert max(cells.values()) <= 2


def test_border_suppression():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (64, 64)).astype(np.float32)
    xy, _, valid = detect_keypoints(
        jnp.asarray(img[None]), max_keypoints=512, border=10
    )
    got = np.asarray(xy)[0][np.asarray(valid)[0]]
    assert np.all(got >= 10) and np.all(got < 54)


def test_fast_response_corner_vs_edge_vs_flat():
    from densepoints.features.detector import fast_response

    # A bright square on dark background: its corners pass FAST-9, the
    # middle of its edges must not (only ~half the ring differs there).
    img = np.zeros((48, 48), np.float32)
    img[16:32, 16:32] = 200.0
    resp = np.asarray(fast_response(jnp.asarray(img[None]), threshold=20.0))[0]
    assert resp[16, 16] > 0  # corner pixel is a FAST corner
    assert not np.isfinite(resp[16, 24])  # edge midpoint: -inf
    assert not np.isfinite(resp[8, 8])  # flat background: -inf


def test_detect_keypoints_fast_method():
    # FAST needs isolated corners (X-junctions have no 9-contiguous arc),
    # so use a lattice of bright squares on a dark background.
    img = np.zeros((96, 96), np.float32)
    for y0 in range(16, 80, 24):
        for x0 in range(16, 80, 24):
            img[y0 : y0 + 10, x0 : x0 + 10] = 200.0
    xy, resp, valid = detect_keypoints(
        jnp.asarray(img[None]),
        cell_size=16,
        max_per_cell=4,
        max_keypoints=256,
        method="fast",
        fast_threshold=20.0,
    )
    got = np.asarray(xy)[0][np.asarray(valid)[0]]
    assert len(got) >= 9  # at least one corner per square
    # Every keypoint is within 3 px of a square corner.
    corners = np.array(
        [
            (x0 + dx, y0 + dy)
            for y0 in range(16, 80, 24)
            for x0 in range(16, 80, 24)
            for dy in (0, 9)
            for dx in (0, 9)
        ],
        np.float32,
    )
    d = np.linalg.norm(got[:, None, :] - corners[None], axis=-1).min(1)
    assert np.all(d <= 3), got[d > 3]
