"""Regression tests for the f32-geometry matmul-precision contract.

Failure mode being pinned: under a reduced default matmul precision, f32
matmuls/einsums run with fewer mantissa bits (TF32 tensor cores on an
NVIDIA GPU keep 10). Projection matrices multiplied that way put texel
coordinates whole pixels off at scan-scale coordinates (1600x1200, focal
~2900), which moves NCC scores by > 1e-2 and flips accept decisions at
the 0.6 threshold.

Two independent guards, each with its own test so reverting either one
fails the suite:

  1. the package-wide default (`densepoints/__init__.py`): importing
     the package sets `jax_default_matmul_precision=highest` when the
     application has not chosen its own;
  2. per-site pins: every pixel-coordinate-producing matmul passes
     `precision=HIGHEST` explicitly, so geometry stays correct even under
     a caller's own precision context (ADVICE r4 medium).

The end-to-end check of this contract (scores vs a numpy f64 oracle at
scan-scale coordinates) lives in tests/ops/test_warp_ncc_paged.py and,
on the GPU, in phase 2 of chip_smoke.py.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np

import densepoints  # noqa: F401  (import applies the global default)
from densepoints.core.cameras import Cameras


def _scan_scale_cameras(n=3):
    """The DTU-class camera family: 1600x1200, focal ~2900 — coordinates
    large enough that TF32/bf16 rounding moves pixel positions by whole
    px."""
    rng = np.random.default_rng(0)
    K = np.array([[2900.0, 0, 800.0], [0, 2900.0, 600.0], [0, 0, 1.0]])
    Ps = []
    for i in range(n):
        ang = (i - (n - 1) / 2) * 0.15
        C = np.array([600 * np.sin(ang), 40.0 * i, -600 * np.cos(ang)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        Ps.append(K @ np.concatenate([R, (-R @ C)[:, None]], 1))
    return Cameras.from_projection_matrices(
        np.stack(Ps), widths=1600, heights=1200
    )


def test_package_import_sets_global_highest():
    # Reverting densepoints/__init__.py's config.update line fails
    # here. The test environment never sets its own default, so the
    # non-clobbering guard must have applied the package default.
    assert jax.config.jax_default_matmul_precision == "highest", (
        "package import must default f32 matmuls to HIGHEST: reduced "
        "precision (TF32, bf16) geometry matmuls corrupt pixel coordinates"
    )


def _lowered_precisions(fn, *args):
    with jax.default_matmul_precision("bfloat16"):
        txt = jax.jit(fn).lower(*args).as_text()
    return set(re.findall(r"precision = \[(\w+)", txt))


def test_camera_projection_pinned_highest():
    # Reverting the per-site `precision=HIGHEST` pins in
    # core/cameras.py:project fails here: under an application's bf16
    # context the lowered program would carry DEFAULT precision.
    cams = _scan_scale_cameras()
    prec = _lowered_precisions(
        lambda c, p: c.project(p), cams, jnp.zeros((8, 3))
    )
    assert prec == {"HIGHEST"}, prec


def test_patch_frames_pinned_highest():
    from densepoints.ops.warp import patch_frames

    cams = _scan_scale_cameras()
    B = 8
    prec = _lowered_precisions(
        lambda c, p, n, r: patch_frames(c, p, n, r, 11),
        cams,
        jnp.zeros((B, 3)),
        jnp.tile(jnp.asarray([0.0, 0.0, 1.0]), (B, 1)),
        jnp.zeros((B,), jnp.int32),
    )
    assert prec == {"HIGHEST"}, prec
