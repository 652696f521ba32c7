"""Stage-boundary checkpoint / resume.

The reference has no persistence at all (SURVEY.md §5.4 — each run is
monolithic). Here every pipeline stage boundary (seeds, optimized seeds,
per-round expansion state, BA state) can snapshot its PatchState + metadata
to a single .npz and resume from it — cheap insurance for long DTU/T&T runs
and the restart point for elastic multi-host scheduling.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from densepoints.pmvs.patch import PatchState

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]

_FIELDS = ("position", "normal", "ref", "vis", "cand", "alive", "color")


def save_checkpoint(
    path,
    state: PatchState,
    stage: str,
    extra: dict | None = None,
    cameras=None,
):
    """Snapshot patch state (+ optionally the cameras that produced it).

    Cameras matter when bundle adjustment refined the extrinsics: a resumed
    run must reconstruct with the SAME geometry the patches were optimized
    against, not the scene file's original cameras.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f: np.asarray(getattr(state, f)) for f in _FIELDS}
    if cameras is not None:
        # Save EVERY derived field, not just P: rebuilding K/R/C from P via
        # RQ decomposition on load is a ulp-level round-trip that breaks
        # bitwise resume determinism (the batched NM amplifies camera-frame
        # ulps into diverging patch poses).
        arrays["__cam_P__"] = np.asarray(cameras.P)
        arrays["__cam_K__"] = np.asarray(cameras.K)
        arrays["__cam_E__"] = np.asarray(cameras.E)
        arrays["__cam_C__"] = np.asarray(cameras.C)
        arrays["__cam_x__"] = np.asarray(cameras.x_axis)
        arrays["__cam_w__"] = np.asarray(cameras.width)
        arrays["__cam_h__"] = np.asarray(cameras.height)
    meta = {"stage": stage, "capacity": state.capacity}
    if extra:
        meta.update(extra)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_checkpoint(path):
    """Returns (PatchState, meta dict, Cameras-or-None)."""
    from densepoints.core.cameras import Cameras

    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        state = PatchState(
            **{f: jnp.asarray(data[f]) for f in _FIELDS}
        )
        cameras = None
        if "__cam_K__" in data:  # bit-faithful restore of derived fields
            cameras = Cameras(
                P=jnp.asarray(data["__cam_P__"]),
                K=jnp.asarray(data["__cam_K__"]),
                E=jnp.asarray(data["__cam_E__"]),
                C=jnp.asarray(data["__cam_C__"]),
                x_axis=jnp.asarray(data["__cam_x__"]),
                width=jnp.asarray(data["__cam_w__"]),
                height=jnp.asarray(data["__cam_h__"]),
            )
        elif "__cam_P__" in data:  # older checkpoints: re-derive from P
            cameras = Cameras.from_projection_matrices(
                data["__cam_P__"],
                widths=data["__cam_w__"],
                heights=data["__cam_h__"],
            )
    return state, meta, cameras


def latest_checkpoint(directory):
    """Most recent .npz checkpoint in a directory, or None."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    candidates = sorted(
        directory.glob("*.npz"), key=lambda p: p.stat().st_mtime
    )
    return candidates[-1] if candidates else None
