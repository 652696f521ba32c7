"""DTU-scale end-to-end densification on one GPU -> a JSON artifact.

The BASELINE ladder's config-3 scale (a DTU scan: 49 views, 1600x1200)
run hermetically: a DTU-shaped synthetic — 49 cameras on a 7x7 angular
grid 650 mm from a textured 60 mm sphere, 1600x1200 px at DTU-like focal
length (cal18 fx ~ 2900 px) — so the artifact carries ground-truth
accuracy/completeness (utils/metrics.py DTU protocol, mm units) alongside
patch counts and per-stage wall time. Parity target: the full reference
loop `methods/pmvs/pmvs.cpp:22-27` at `programs/densify/main.cpp:12-40`
scene scale (the reference itself cannot run it: its pipeline is
unfinished, README.md:3).

Usage:  python scripts/dtu_scale_run.py [--out dtu_run.json]
        [--views 49] [--width 1600] [--height 1200] [--kp 4096]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))


def _tail_forensics(result, cloud, acc_exact, radius, scene_gen, thr):
    """Classify the > threshold exact-accuracy population (VERDICT r4 #6).

    Hypotheses from the round-4 verdict: fringe normals (patch normal
    off the true surface normal), low-view patches, rim patches (grazing
    viewing angles), outward vs inward floaters. Reported for the tail
    AND the inlier population so the deltas are readable.
    """
    if not len(cloud):
        return {}
    normals = result.normals
    vis_counts = np.asarray(result.patches.vis).sum(axis=1)
    n_gt = cloud / np.maximum(
        np.linalg.norm(cloud, axis=1, keepdims=True), 1e-9
    )
    align = np.abs(np.sum(normals * n_gt, axis=1)) / np.maximum(
        np.linalg.norm(normals, axis=1), 1e-9
    )
    # Rim-ness: angle between the inward surface normal and the mean
    # camera direction (the grazing band sits near the 0.78 rad cutoff).
    mean_cam = scene_gen.C.mean(axis=0)
    mean_cam /= np.linalg.norm(mean_cam)
    rim_angle = np.arccos(np.clip(n_gt @ mean_cam, -1, 1))
    outward = np.linalg.norm(cloud, axis=1) > radius
    tail = acc_exact > thr

    def side(mask):
        n = int(mask.sum())
        if n == 0:
            return {"count": 0}
        return {
            "count": n,
            "normal_alignment_median": round(
                float(np.median(align[mask])), 4
            ),
            "visible_views_mean": round(
                float(np.mean(vis_counts[mask])), 2
            ),
            "rim_angle_median_rad": round(
                float(np.median(rim_angle[mask])), 4
            ),
            "frac_outward": round(float(np.mean(outward[mask])), 4),
            "exact_mm_median": round(
                float(np.median(acc_exact[mask])), 4
            ),
        }

    return {
        "threshold_mm": thr,
        "tail": side(tail),
        "inliers": side(~tail),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="dtu_run.json")
    p.add_argument("--views", type=int, default=49)
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--height", type=int, default=1200)
    p.add_argument("--kp", type=int, default=4096,
                   help="max keypoints per view (reference ORB uses 40000)")
    p.add_argument("--max-per-cell", type=int, default=4,
                   help="grid-filter keypoints per 16px cell (the knob "
                   "that actually binds at DTU image sizes: the detector "
                   "yields ~3.1k corners/view under top-4/cell, so the "
                   "kp cap is slack)")
    p.add_argument("--focal", type=float, default=2900.0)
    p.add_argument("--radius", type=float, default=60.0, help="object mm")
    p.add_argument("--cam-radius", type=float, default=650.0)
    p.add_argument("--max-rounds", type=int, default=12)
    p.add_argument("--nm-iters", type=int, default=120,
                   help="Nelder-Mead iteration cap (reference cap is 500; "
                   "the batched solver's global early exit usually fires "
                   "far earlier — this caps worst-case wall time)")
    p.add_argument("--score-views", type=int, default=25,
                   help="optimize.max_score_views (the scan profile's "
                   "value; only the chunked parity reference reads it)")
    p.add_argument("--threshold-mm", type=float, default=2.0)
    p.add_argument("--grid-scale", type=int, default=8,
                   help="occupancy cell size in px (patch_organizer.h:46 "
                   "default 8); 4 doubles linear patch density — the "
                   "standard PMVS density knob")
    p.add_argument("--expand-nm-iters", type=int, default=0,
                   help="Nelder-Mead cap for EXPANSION candidates only "
                   "(0 = same as --nm-iters); candidates start one grid "
                   "cell from a converged parent, so ~40 converges")
    p.add_argument("--surface", action="store_true",
                   help="also extract a TSDF surface and report mesh-vertex "
                   "distance to the analytic sphere (BASELINE config-5 "
                   "'large scene + surface')")
    args = p.parse_args(argv)

    from synthetic import TexturedSphereScene

    from densepoints.config import load_config
    from densepoints.core.cameras import Cameras
    from densepoints.io.scene import Scene
    from densepoints.pmvs.pipeline import densify
    from densepoints.utils.metrics import accuracy_completeness

    from densepoints.utils.cache import enable_compilation_cache

    # Same persistent compile cache the production entry points use
    # (utils/cache.py): repeat runs skip the one-time compiles.
    enable_compilation_cache()

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    scene_gen = TexturedSphereScene(
        rng,
        num_views=args.views,
        width=args.width,
        height=args.height,
        focal=args.focal,
        radius=args.radius,
        cam_radius=args.cam_radius,
        tex_size=4096,
        layout="grid",
        yaw_span=1.0,
        pitch_span=0.5,
    )
    images = scene_gen.render_all()
    t_render = time.perf_counter() - t0
    print(f"rendered {args.views} views {args.width}x{args.height} "
          f"in {t_render:.1f}s "
          f"({images.nbytes / 1e6:.0f} MB f32)", flush=True)

    cams = Cameras.from_projection_matrices(
        scene_gen.P, widths=args.width, heights=args.height
    )
    scene = Scene(cameras=cams, images=images, colors=None)

    ckpt_dir = (
        f"/tmp/dtu_ckpt_{args.views}x{args.width}x{args.height}"
        f"_kp{args.kp}_pc{args.max_per_cell}_r{args.radius:g}"
        f"_f{args.focal:g}_d{args.cam_radius:g}_g{args.grid_scale}"
    )
    config = load_config(
        {
            "matching": {
                "max_keypoints_per_view": args.kp,
                "max_keypoints_per_cell": args.max_per_cell,
                # all C(49,2)=1176 pairs is the reference default; prune to
                # covisible neighbors at scan scale (SURVEY §2.4 pair list)
                "max_pairs_per_view": 10,
            },
            "optimize": {
                "max_iterations": args.nm_iters,
                "max_score_views": args.score_views,
            },
            "expand": {
                "max_rounds": args.max_rounds,
                "max_iterations": args.expand_nm_iters,
            },
            "organizer": {"grid_scale": args.grid_scale},
            # Scan-scale filter preset (the `scan` profile's filter
            # section), picked with a filter sweep on this scene.
            "filter": {
                "min_support_cells": 4,
                "depth_consistency": 0.005,
                "occlusion_slack": 0.02,
            },
            # Stage checkpoints: a crashed/tuned rerun resumes past the
            # (compile-dominated) seed stage.
            "runtime": {"checkpoint_dir": ckpt_dir, "resume": True},
        }
    )

    t1 = time.perf_counter()
    result = densify(scene, config)
    t_densify = time.perf_counter() - t1

    cloud = result.positions
    # Ground truth: uniform sphere samples inside the reconstructible set —
    # within the 0.78 rad visible cone (patch.h:56 semantics, inward normal
    # -p/r vs the ray from each camera) of >= min_visible_views cameras,
    # mirroring what a surviving patch must satisfy.
    gt_rng = np.random.default_rng(1)
    pts = gt_rng.standard_normal((200_000, 3)).astype(np.float32)
    pts *= args.radius / np.linalg.norm(pts, axis=1, keepdims=True)
    n_in = -pts / args.radius
    vis_count = np.zeros(len(pts), np.int32)
    for C in scene_gen.C:
        d = pts - C.astype(np.float32)
        cosang = np.sum(d * n_in, axis=1) / np.linalg.norm(d, axis=1)
        vis_count += (np.arccos(np.clip(cosang, -1, 1)) < 0.78)
    gt = pts[vis_count >= 3]
    metrics = accuracy_completeness(
        cloud, gt, threshold=args.threshold_mm, max_dist=20.0
    )
    # Analytic accuracy: exact distance to the sphere, | |p| - r | — free of
    # GT sampling density effects.
    acc_exact = (
        np.abs(np.linalg.norm(cloud, axis=1) - args.radius)
        if len(cloud)
        else np.array([np.nan])
    )
    print(metrics.summary(), flush=True)

    patches = int(cloud.shape[0])
    artifact = {
        "scene": {
            "kind": "synthetic_dtu_sphere",
            "views": args.views,
            "width": args.width,
            "height": args.height,
            "focal_px": args.focal,
            "object_radius_mm": args.radius,
            "camera_distance_mm": args.cam_radius,
            "pixel_footprint_mm": args.cam_radius / args.focal,
        },
        "config": {
            "max_keypoints_per_view": args.kp,
            "max_keypoints_per_cell": args.max_per_cell,
            "max_pairs_per_view": 10,
            "nm_iterations": args.nm_iters,
            "max_score_views": args.score_views,
            "expand_max_rounds": args.max_rounds,
            "grid_scale": args.grid_scale,
            "expand_nm_iterations": args.expand_nm_iters,
        },
        "patches": patches,
        "densify_seconds": round(t_densify, 2),
        "patches_per_sec_end_to_end": round(patches / t_densify, 1),
        "stage_seconds": {
            k: round(v, 2) for k, v in result.metrics.times.items()
        },
        "counters": {
            k: float(v) for k, v in result.metrics.counters.items()
        },
        "quality_mm": {
            "threshold_mm": args.threshold_mm,
            "accuracy_mean": round(metrics.accuracy_mean, 4),
            "accuracy_median": round(metrics.accuracy_median, 4),
            "completeness_mean": round(metrics.completeness_mean, 4),
            "completeness_median": round(metrics.completeness_median, 4),
            "accuracy_frac_under": round(metrics.accuracy_frac_under, 4),
            "completeness_frac_under": round(
                metrics.completeness_frac_under, 4
            ),
            "accuracy_exact_mean": round(float(np.mean(acc_exact)), 4),
            "accuracy_exact_median": round(
                float(np.median(acc_exact)), 4
            ),
            "accuracy_exact_p95": round(
                float(np.percentile(acc_exact, 95)), 4
            ),
            "accuracy_exact_p99": round(
                float(np.percentile(acc_exact, 99)), 4
            ),
        },
        # Tail forensics (VERDICT r4 #6): who are the > threshold patches?
        "tail_mm": _tail_forensics(
            result, cloud, acc_exact, args.radius, scene_gen,
            args.threshold_mm,
        ),
    }
    if args.surface:
        from densepoints.config import SurfaceConfig
        from densepoints.surface.tsdf import extract_surface

        ts = time.perf_counter()
        verts, faces = extract_surface(
            result.positions,
            result.normals,
            SurfaceConfig(
                enable=True, voxel_resolution=192, min_weight=2.0
            ),
        )
        t_surface = time.perf_counter() - ts
        verts = np.asarray(verts)
        vex = (
            np.abs(np.linalg.norm(verts, axis=1) - args.radius)
            if len(verts)
            else np.array([np.nan])
        )
        artifact["surface"] = {
            "voxel_resolution": 192,
            "min_weight": 2.0,
            "vertices": int(len(verts)),
            "faces": int(len(np.asarray(faces))),
            "extract_seconds": round(t_surface, 1),
            "vertex_dist_mm": {
                "median": round(float(np.median(vex)), 3),
                "mean": round(float(np.mean(vex)), 3),
                "p95": round(float(np.percentile(vex, 95)), 3),
            },
        }
        print("surface:", artifact["surface"], flush=True)

    import jax

    artifact["device"] = str(jax.devices()[0].device_kind)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
