"""Smoke run of the densify main path on an NVIDIA GPU.

    python chip_smoke.py              # phases 1-3 on one card
    python chip_smoke.py --chips 4    # phase 4 only, on four cards

Phases (any failure exits non-zero; the last stdout line is printed only
when every phase passed):

  1. Device check: the default JAX device must be a GPU (no CPU fallback).
  2. Scoring parity at real widths: the scan-scale scene (4 views at
     1600x1200, focal 2900, 64 patches spread +-60 mm) scored by every GPU
     scoring implementation against the float64 numpy oracle
     (tests/oracle.py). Both implementations sample f32 images at f32
     coordinates from HIGHEST-precision (never TF32) geometry, so they sit
     within 1e-3 |dNCC| of the oracle; TF32 or bf16 geometry moves window
     corners by whole pixels at these coordinates and errs by > 1e-2.
  3. Main path on one card: the DTU-class synthetic scan (49 views at
     1600x1200, focal 2900, seeded) through `densify` with the `scan`
     profile — detect, match, tracks, triangulate, seed, optimize, expand,
     filter, color — three times: first-ever cold (compile cache empty),
     cached cold (in-memory caches cleared, persistent cache warm) and
     warm. Accuracy is scored against the analytic sphere.
  4. (--chips 4) `densify_distributed` on a 4-card mesh against the same
     driver on a 1-card mesh, plus `__graft_entry__.dryrun_multichip(4)`.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

PARITY_TOL = 1e-3  # max |dNCC| vs the float64 oracle (f32 sampling)
ACCURACY_MEDIAN_MM = 0.5  # exact median distance to the sphere (~2 px)
SMOKE_MAX_ROUNDS = 4  # expansion rounds in phase 3 (scan profile: 12)
MULTI_MAX_ROUNDS = 2  # expansion rounds in phase 4


def _say(*parts):
    print(*parts, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def phase_device(n_chips: int):
    import jax
    import jaxlib

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"phase 1 failed: default device is {devices[0].platform!r}, "
            "not a GPU"
        )
    if len(devices) < n_chips:
        raise SystemExit(
            f"phase 1 failed: {len(devices)} GPU(s) visible, need {n_chips}"
        )
    _say(
        f"[phase 1] device {devices[0].device_kind} x{len(devices)}; "
        f"jax {jax.__version__} jaxlib {jaxlib.__version__}"
    )
    _say(f"[phase 1] nvidia-smi: {_nvidia_smi()}")
    return devices


def phase_parity():
    import jax.numpy as jnp

    from densepoints.ops.allview import (
        allview_scores_triton,
        allview_scores_xla,
    )
    from tests.oracle import (
        allview_scores_numpy,
        compare_to_oracle,
        scan_scale_case,
    )

    cams, images, pos, nrm, refs, vis = scan_scale_case(
        np.random.default_rng(0)
    )
    args = (
        jnp.asarray(images), cams, jnp.asarray(pos), jnp.asarray(nrm),
        jnp.asarray(refs), jnp.asarray(vis),
    )
    impls = {
        "allview_scores_triton": allview_scores_triton,
        "allview_scores_xla": allview_scores_xla,
    }
    for k in (11, 16):
        want = allview_scores_numpy(cams, images, pos, nrm, refs, vis, k)
        for name, fn in impls.items():
            got = np.asarray(fn(*args, k)[0])
            st = compare_to_oracle(got, want, PARITY_TOL)
            _say(
                f"[phase 2] {name} k={k}: scored {st['scored']} "
                f"max|dNCC| {st['max_abs']:.3e} mean {st['mean_abs']:.3e} "
                f"accept@0.6 agreement {st['accept_agreement']:.4f} "
                f"over {st['decisive']} decisive (tol {PARITY_TOL:g}, f32)"
            )
            if not (
                st["scored"] > 0
                and st["max_abs"] <= PARITY_TOL
                and st["sentinels_match"]
                and st["accept_agreement"] == 1.0
            ):
                raise SystemExit(f"phase 2 failed: {name} k={k}: {st}")


def dtu_scene(seed: int = 0):
    """The DTU-class synthetic scan (scripts/dtu_scale_run.py geometry)."""
    from densepoints.core.cameras import Cameras
    from densepoints.io.scene import Scene
    from tests.synthetic import TexturedSphereScene

    gen = TexturedSphereScene(
        np.random.default_rng(seed), num_views=49, width=1600, height=1200,
        focal=2900.0, radius=60.0, cam_radius=650.0, tex_size=4096,
        layout="grid", yaw_span=1.0, pitch_span=0.5,
    )
    cams = Cameras.from_projection_matrices(
        gen.P, widths=gen.width, heights=gen.height
    )
    return Scene(cameras=cams, images=gen.render_all(), colors=None), gen


def sphere_quality(cloud: np.ndarray, gen, radius: float = 60.0):
    """Exact accuracy |‖p‖ - r| and DTU-protocol completeness (mm)."""
    from densepoints.utils.metrics import accuracy_completeness

    pts = np.random.default_rng(1).standard_normal((200_000, 3))
    pts *= radius / np.linalg.norm(pts, axis=1, keepdims=True)
    n_in = -pts / radius
    seen = np.zeros(len(pts), np.int32)
    for C in gen.C:  # reconstructible: inside the 0.78 rad cone of >= 3
        d = pts - C
        cos = np.sum(d * n_in, axis=1) / np.linalg.norm(d, axis=1)
        seen += np.arccos(np.clip(cos, -1, 1)) < 0.78
    m = accuracy_completeness(cloud, pts[seen >= 3], threshold=2.0,
                              max_dist=20.0)
    exact = np.abs(np.linalg.norm(cloud, axis=1) - radius)
    return {
        "accuracy_exact_mean_mm": float(exact.mean()),
        "accuracy_exact_median_mm": float(np.median(exact)),
        "completeness_mean_mm": m.completeness_mean,
        "completeness_frac_under_2mm": m.completeness_frac_under,
    }


def _smoke_config(max_rounds: int):
    from densepoints.config import load_config

    return load_config(
        {"profile": "scan", "expand": {"max_rounds": max_rounds}}
    )


def phase_main_path(device, cache_dir):
    import jax

    from densepoints.pmvs.optimize import scoring_path
    from densepoints.pmvs.pipeline import densify

    t0 = time.perf_counter()
    scene, gen = dtu_scene()
    _say(
        f"[phase 3] scene: 49 views 1600x1200 built in "
        f"{time.perf_counter() - t0:.1f}s (set-up)"
    )
    config = _smoke_config(SMOKE_MAX_ROUNDS)
    _say(
        f"[phase 3] expand.max_rounds cut 12 -> {SMOKE_MAX_ROUNDS} to fit "
        "the smoke time budget; views and resolution are not cut"
    )
    _say(f"[phase 3] scoring implementation: {scoring_path()}")
    cdir = pathlib.Path(cache_dir) if cache_dir else None
    cached = bool(cdir and cdir.is_dir() and any(cdir.iterdir()))
    runs = {}
    for label in ("first_cold", "cached_cold", "warm"):
        if label == "cached_cold":
            jax.clear_caches()  # drop in-memory executables only
        t = time.perf_counter()
        result = densify(scene, config)
        jax.block_until_ready(result.patches.position)
        runs[label] = (time.perf_counter() - t, result)
        m = result.metrics
        _say(
            f"[phase 3] {label}: {runs[label][0]:.2f}s "
            f"patches {result.patches.capacity} stages "
            + json.dumps({k: round(v, 3) for k, v in m.times.items()})
            + " counters "
            + json.dumps({k: float(v) for k, v in m.counters.items()})
        )
    _say(
        f"[phase 3] compile cache {cache_dir} "
        f"({'held entries' if cached else 'empty'} at start)"
    )
    warm_s, result = runs["warm"]
    cloud = result.positions
    n = int(cloud.shape[0])
    if n == 0:
        raise SystemExit("phase 3 failed: empty cloud")
    counts = {r.patches.capacity for _, r in runs.values()}
    q = sphere_quality(cloud, gen)
    peak = device.memory_stats().get("peak_bytes_in_use", -1)
    _say(
        f"[phase 3] final patches {n} (all runs {sorted(counts)}); "
        f"warm {n / warm_s:.1f} patches/s; "
        + " ".join(f"{k} {v:.4f}" for k, v in q.items())
        + f"; peak_bytes_in_use {peak}"
    )
    if not q["accuracy_exact_median_mm"] <= ACCURACY_MEDIAN_MM:
        raise SystemExit(
            f"phase 3 failed: exact median accuracy "
            f"{q['accuracy_exact_median_mm']:.4f} mm > {ACCURACY_MEDIAN_MM}"
        )


def phase_multichip(devices):
    from densepoints.parallel.mesh import make_mesh
    from densepoints.parallel.pipeline import densify_distributed

    import __graft_entry__

    scene, gen = dtu_scene()
    config = _smoke_config(MULTI_MAX_ROUNDS)
    _say(f"[phase 4] expand.max_rounds cut 12 -> {MULTI_MAX_ROUNDS}")
    clouds = {}
    for n in (1, 4):
        t = time.perf_counter()
        res = densify_distributed(
            scene, config, mesh=make_mesh(n, devices=devices)
        )
        clouds[n] = res.positions
        _say(
            f"[phase 4] densify_distributed on {n} GPU(s): "
            f"{time.perf_counter() - t:.2f}s patches {len(res.positions)} "
            + json.dumps({k: round(v, 3) for k, v in res.metrics.times.items()})
        )
    a, b = clouds[1], clouds[4]
    if len(a) == 0 or a.shape != b.shape:
        raise SystemExit(
            f"phase 4 failed: patch counts 1-GPU {len(a)} vs 4-GPU {len(b)}"
        )
    diff = float(np.max(np.abs(a - b))) if len(a) else 0.0
    _say(
        f"[phase 4] 1 vs 4 GPUs: {len(a)} patches each, "
        f"bit-identical {bool(np.array_equal(a, b))}, max |dpos| {diff:.3e}"
    )
    if diff > 1e-3:  # mm; far below the 0.22 mm pixel footprint
        raise SystemExit(f"phase 4 failed: positions differ by {diff} mm")
    __graft_entry__.dryrun_multichip(4)
    q = sphere_quality(b, gen)
    _say("[phase 4] 4-GPU cloud " + " ".join(
        f"{k} {v:.4f}" for k, v in q.items()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)

    import jax

    from densepoints.utils.cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    devices = phase_device(args.chips)
    if args.chips == 4:
        phase_multichip(devices[:4])
    else:
        phase_parity()
        phase_main_path(devices[0], cache_dir)
    d = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform,
            "kind": d.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
