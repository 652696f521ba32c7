"""Grade the pipeline on a scene that OCCLUDES ITSELF (VERDICT r4 #5).

Every earlier quality artifact used convex geometry (spheres, planes)
where the occlusion filter, visibility classification, and depth-coherence
semantics have no real work. This run uses `MultiObjectScene` (two
spheres + a background plane: real self-occlusion, depth discontinuities,
background surface) through the ON-DISK DTU-layout path with the same
photometric nuisances as scripts/dtu_layout_run.py, and reports:

  * accuracy (exact analytic distance to the surface union) and
    completeness (vs GT samples on the VISIBLE parts of the union);
  * occlusion-filter forensics: the patches `filter_occlusion` kills on
    the expanded cloud, classified against ground truth — a kill is
    JUSTIFIED if the patch either sits off the true surface (> thr) or
    claims visibility in a view where the segment test says its position
    is occluded by another object. This is the first artifact where the
    filter's kills can be graded at all.

Usage: python scripts/occlusion_run.py [--out occlusion_run.json]
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="occlusion_run.json")
    p.add_argument("--views", type=int, default=21)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--kp", type=int, default=2048)
    p.add_argument("--max-rounds", type=int, default=6)
    p.add_argument("--threshold-mm", type=float, default=2.0)
    p.add_argument("--clean", action="store_true")
    args = p.parse_args(argv)

    from PIL import Image

    from dtu_layout_run import add_nuisances
    from synthetic import MultiObjectScene

    from densepoints.config import load_config
    from densepoints.io.datasets import dtu_to_scene_json
    from densepoints.io.scene import load_scene
    from densepoints.pmvs.filter import filter_occlusion
    from densepoints.pmvs.pipeline import densify
    from densepoints.utils.checkpoint import load_checkpoint
    from densepoints.utils.metrics import accuracy_completeness

    from densepoints.utils.cache import enable_compilation_cache

    # Same persistent compile cache the production entry points use
    # (utils/cache.py): repeat runs skip the one-time compiles.
    enable_compilation_cache()

    rng = np.random.default_rng(0)
    sc = MultiObjectScene(
        rng,
        num_views=args.views,
        width=args.width,
        height=args.height,
    )
    images = sc.render_all().astype(np.float32)
    if not args.clean:
        # Same nuisance model as scripts/dtu_layout_run.py (gain/bias, vignette,
        # specular lobe, noise, 8-bit PNG); the "pole" flattening lands on
        # the back sphere.
        images = add_nuisances(images, sc, rng, sc.spheres[1][1])

    tag = "clean" if args.clean else "nuisance"
    root = Path(f"/tmp/occlusion_layout_{tag}_{args.views}")
    calib, rect = root / "Calibration", root / "Rectified"
    calib.mkdir(parents=True, exist_ok=True)
    rect.mkdir(parents=True, exist_ok=True)
    for i in range(args.views):
        np.savetxt(calib / f"pos_{i + 1:03d}.txt", sc.P[i])
        Image.fromarray(np.clip(images[i], 0, 255).astype(np.uint8)).save(
            rect / f"rect_{i + 1:03d}_max_r5000.png"
        )
    scene_json = dtu_to_scene_json(calib, rect, root / "scene.json")
    scene = load_scene(scene_json)
    config = load_config(
        {
            "profile": "scan",
            "matching": {"max_keypoints_per_view": args.kp},
            "optimize": {"max_iterations": 120},
            "expand": {
                "max_rounds": args.max_rounds, "max_iterations": 40,
            },
            "runtime": {"checkpoint_dir": str(root / "ckpt")},
        }
    )
    t0 = time.perf_counter()
    result = densify(scene, config)
    t_densify = time.perf_counter() - t0
    cloud = result.positions

    # ---- quality vs analytic ground truth ----------------------------
    acc = sc.distance_to_surface(cloud) if len(cloud) else np.array([np.nan])
    gt = sc.sample_visible_surface(np.random.default_rng(1), 60_000)
    metrics = accuracy_completeness(
        cloud, gt, threshold=args.threshold_mm, max_dist=20.0
    )
    print(metrics.summary(), flush=True)

    # ---- occlusion-filter forensics on the expanded cloud ------------
    exp_state, _, _ = load_checkpoint(root / "ckpt" / "expanded.npz")
    pos = np.asarray(exp_state.position)
    vis = np.asarray(exp_state.vis)
    alive = np.asarray(exp_state.alive)
    filtered = filter_occlusion(
        scene.cameras,
        exp_state,
        grid_scale=config.organizer.grid_scale,
        occlusion_slack=config.filter.occlusion_slack,
        min_visible_views=config.optimize.min_visible_views,
    )
    killed = alive & ~np.asarray(filtered.alive)
    kept = alive & np.asarray(filtered.alive)

    # Ground-truth classification of each patch:
    # off-surface: > thr from the union; phantom-visible: claims >= 1
    # view where its position is occluded by ANOTHER surface.
    d_surf = sc.distance_to_surface(pos)
    occluded_claims = np.zeros(len(pos), np.int32)
    for v in range(args.views):
        visible = sc.point_visible(pos, v, eps=5e-3)
        occluded_claims += vis[:, v] & ~visible
    off_surface = d_surf > args.threshold_mm
    bad = off_surface | (occluded_claims >= 1)

    def stats(mask):
        n = int(mask.sum())
        if n == 0:
            return {"count": 0}
        return {
            "count": n,
            "gt_dist_median": round(float(np.median(d_surf[mask])), 4),
            "gt_dist_p95": round(
                float(np.percentile(d_surf[mask], 95)), 4
            ),
            "frac_off_surface": round(float(off_surface[mask].mean()), 4),
            "frac_with_occluded_claims": round(
                float((occluded_claims[mask] >= 1).mean()), 4
            ),
            "frac_justified": round(float(bad[mask].mean()), 4),
        }

    artifact = {
        "scene": {
            "kind": f"multi_object_occlusion_{tag}",
            "objects": "sphere r55 front + sphere r70 back + plane z=220",
            "views": args.views,
            "width": args.width,
            "height": args.height,
            "layout_dir": str(root),
            "nuisances": [] if args.clean else [
                "per_view_gain_bias", "vignetting_25pct",
                "view_dependent_specular_lobe", "sensor_noise_sigma2",
                "8bit_png_quantization",
            ],
        },
        "patches": int(len(cloud)),
        "densify_seconds": round(t_densify, 2),
        "stage_seconds": {
            k: round(v, 2) for k, v in result.metrics.times.items()
        },
        "quality_mm": {
            "threshold_mm": args.threshold_mm,
            "accuracy_exact_mean": round(float(np.mean(acc)), 4),
            "accuracy_exact_median": round(float(np.median(acc)), 4),
            "accuracy_exact_p95": round(
                float(np.percentile(acc, 95)), 4
            ),
            "accuracy_exact_p99": round(
                float(np.percentile(acc, 99)), 4
            ),
            "completeness_median": round(metrics.completeness_median, 4),
            "completeness_frac_under": round(
                metrics.completeness_frac_under, 4
            ),
            "accuracy_frac_under": round(metrics.accuracy_frac_under, 4),
        },
        "occlusion_filter": {
            "expanded_patches": int(alive.sum()),
            "killed": stats(killed),
            "kept": stats(kept),
            "note": "a kill is justified if the patch is off-surface or "
            "claims visibility through another object; kept patches' "
            "frac_justified is the false-negative view",
        },
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print("wrote", args.out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
