"""Benchmark: end-to-end densification throughput on one GPU.

Prints an early JSON line (refine + scoring numbers) and then a full one
(the last line wins), each naming the device it ran on:

  {"metric": "e2e_patches_per_sec", "value": N, "unit": "patches/s",
   "vs_baseline": R, "device": {...}, ...}

vs_baseline compares against a 100 patches/s end-to-end bar; the
reference itself publishes no numbers (BASELINE.md) and cannot run at all
(its pipeline is unfinished, reference README.md:3).

Components measured:
  * refine_patches_per_sec — batched Nelder-Mead refinement throughput at
    the classic bench shape (8 views, 4096 patches, texture 11, 30 NM
    iterations).
  * scoring_ms_per_call — one all-views scoring pass at the same shape,
    through `pmvs.optimize._allview_scores`, i.e. the implementation the
    platform dispatches (named in `scoring_path`).
  * e2e — seed points -> refine -> expand -> filter -> color on a
    textured-sphere scene (12 views, 512x384), timed warm with a stage
    breakdown; compile overhead = cold minus warm.

Timing: every timed region ends in `block_until_ready`; the first call of
each shape (compile) runs before the window. The persistent compilation
cache (utils/cache.py) is enabled, so `densify_cold_seconds` is the
cached-cold time whenever an earlier run filled the cache. Runs only on a
GPU: no number from another backend is reported.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
E2E_BASELINE_PATCHES_PER_SEC = 100.0
REFINE_NOMINAL_PATCHES_PER_SEC = 10_000.0


def _device_info():
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU (default device: {d.platform})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "name_power_limit": smi,
    }


def _bench_problem(rng):
    from densepoints.core.cameras import Cameras
    from densepoints.pmvs.patch import PatchState

    num_views, H, W = 8, 480, 640
    num_patches = 4096
    K = np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]])
    Ps = []
    for i in range(num_views):
        ang = (i - (num_views - 1) / 2) * 0.12
        C = np.array([6.0 * np.sin(ang), 0.2 * np.sin(2 * i), -6.0 * np.cos(ang)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        Ps.append(K @ np.concatenate([R, (-R @ C)[:, None]], 1))
    cams = Cameras.from_projection_matrices(np.stack(Ps), widths=W, heights=H)
    images = rng.uniform(0, 255, (num_views, H, W)).astype(np.float32)
    xy = rng.uniform(-1.0, 1.0, (num_patches, 2))
    position = np.concatenate([xy, np.zeros((num_patches, 1))], 1)
    normal = np.tile([0.0, 0.0, 1.0], (num_patches, 1))
    vis = np.ones((num_patches, num_views), bool)
    vis[:, 0] = False
    state = PatchState.create(
        position.astype(np.float32), normal.astype(np.float32),
        np.zeros((num_patches,), np.int32), vis,
    )
    return cams, images, state


def main():
    sys.path.insert(0, str(ROOT))
    from densepoints.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    device = _device_info()

    import jax
    import jax.numpy as jnp

    from densepoints.config import OptimizeConfig
    from densepoints.pmvs.optimize import (
        _allview_scores,
        optimize_patches,
        scoring_path,
    )

    rng = np.random.default_rng(0)
    cams, images_np, state = _bench_problem(rng)
    images = jnp.asarray(images_np)
    texture_size = 11
    cfg = OptimizeConfig(max_iterations=30)
    reps = 4

    def refine(seed):
        s = dataclasses.replace(state, position=state.position + seed)
        return optimize_patches(images, cams, s, texture_size, cfg)

    refine(0.0).position.block_until_ready()  # compile + first run
    start = time.perf_counter()
    for i in range(reps):
        out = refine((i + 1) * 1e-4)
    out.position.block_until_ready()
    refine_pps = state.capacity * reps / (time.perf_counter() - start)

    score = jax.jit(
        lambda p: _allview_scores(
            images, cams, p, state.normal, state.ref, state.vis,
            texture_size,
        )[0]
    )
    score(state.position).block_until_ready()
    sreps = 50
    start = time.perf_counter()
    for i in range(sreps):
        s = score(state.position + i * 1e-5)
    s.block_until_ready()
    score_ms = (time.perf_counter() - start) / sreps * 1e3
    n_slots = int(np.asarray(state.vis).sum())

    early = {
        "metric": "refine_patches_per_sec",
        "value": round(refine_pps, 1),
        "unit": "patches/s",
        "vs_baseline": round(refine_pps / REFINE_NOMINAL_PATCHES_PER_SEC, 3),
        "device": device,
        "scoring_path": scoring_path(),
        "scoring_ms_per_call": round(score_ms, 4),
        "scoring_slots_per_sec": round(n_slots / (score_ms * 1e-3), 0),
        "note": "early line: e2e section pending",
    }
    print(json.dumps(early), flush=True)

    # --- end-to-end densify throughput --------------------------------
    sys.path.insert(0, str(ROOT / "tests"))
    from synthetic import TexturedSphereScene

    from densepoints.config import load_config
    from densepoints.core.cameras import Cameras
    from densepoints.io.scene import Scene
    from densepoints.pmvs.optimize import filter_by_error
    from densepoints.pmvs.pipeline import _densify_from
    from densepoints.pmvs.seed import create_patches_from_points
    from densepoints.utils import StageMetrics

    # The object fills ~60% of the frame, so fixed per-stage costs do not
    # dominate the patch throughput.
    sc = TexturedSphereScene(
        rng, num_views=12, width=512, height=384, focal=450.0,
        radius=150.0, cam_radius=500.0, tex_size=2048, layout="grid",
        yaw_span=0.9, pitch_span=0.45,
    )
    dcams = Cameras.from_projection_matrices(
        sc.P, widths=sc.width, heights=sc.height
    )
    dscene = Scene(cameras=dcams, images=sc.render_all(), colors=None)
    g_rng = np.random.default_rng(7)
    seeds = g_rng.standard_normal((3000, 3)).astype(np.float32)
    seeds *= 150.0 / np.linalg.norm(seeds, axis=1, keepdims=True)
    dcfg = load_config(
        {
            "profile": "scan",
            "expand": {"max_rounds": 4, "max_iterations": 40},
            "optimize": {"max_iterations": 120},
            "organizer": {"grid_scale": 4},
        }
    )

    def one_densify(jitter):
        t0 = time.perf_counter()
        dimages = jnp.asarray(dscene.images)
        st = create_patches_from_points(
            dcams, seeds + jitter, dcfg.optimize, dcfg.seed
        )
        st = filter_by_error(
            dimages, dcams, st, dcfg.seed.texture_size, dcfg.optimize
        ).compact()
        st = optimize_patches(
            dimages, dcams, st, dcfg.seed.texture_size, dcfg.optimize
        )
        metrics = StageMetrics()
        result = _densify_from(
            dimages, dcams, dscene, dcfg, metrics, st, "seeds_optimized"
        )
        result.patches.position.block_until_ready()
        return result, metrics, time.perf_counter() - t0

    _, _, ddt_cold = one_densify(0.0)  # includes all stage compiles
    result, metrics, ddt = one_densify(1e-4)  # warm: the throughput run
    n_final = result.patches.capacity
    e2e_pps = n_final / ddt

    full = dict(early)
    full.pop("note")
    full.update(
        {
            "metric": "e2e_patches_per_sec",
            "value": round(e2e_pps, 1),
            "vs_baseline": round(e2e_pps / E2E_BASELINE_PATCHES_PER_SEC, 3),
            "refine_patches_per_sec": round(refine_pps, 1),
            "densify_seconds": round(ddt, 3),
            "densify_cold_seconds": round(ddt_cold, 3),
            "compile_overhead_seconds": round(ddt_cold - ddt, 3),
            "densify_patches_final": n_final,
            "stage_seconds": {
                k: round(v, 3) for k, v in metrics.times.items()
            },
            "e2e_scene": {
                "views": 12, "width": 512, "height": 384,
                "object_frame_fill": "~60%", "grid_scale": 4,
            },
        }
    )
    print(json.dumps(full), flush=True)


if __name__ == "__main__":
    main()
