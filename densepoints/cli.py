"""`densify` command-line interface.

Reference parity: `programs/densify/main.cpp:12-40` — flags `-i/--input`
scene JSON (required) and `-s/--settings` (which the reference parses but
never uses; here it actually loads the config tree), plus output/surface
flags the reference lacked because its export stages were missing.
"""
from __future__ import annotations

import argparse
import sys

from densepoints.config import PipelineConfig, load_config
from densepoints.utils import log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="densify",
        description="PMVS-style multi-view stereo densification",
    )
    p.add_argument("-i", "--input", required=True, help="scene JSON file")
    p.add_argument("-s", "--settings", help="pipeline config JSON")
    p.add_argument(
        "--profile",
        help="named config preset (config.PROFILES, e.g. 'scan' for "
        "DTU-class captures); --settings keys override it",
    )
    p.add_argument(
        "-o", "--output", default="cloud.ply", help="output point cloud (.ply)"
    )
    p.add_argument("--ascii", action="store_true", help="write ascii PLY")
    p.add_argument(
        "--mesh", help="also extract a surface mesh to this path (.ply)"
    )
    p.add_argument(
        "--checkpoint-dir",
        help="write stage-boundary checkpoints here (resume with --resume)",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help="resume from the latest checkpoint in --checkpoint-dir",
    )
    p.add_argument(
        "--debug-dir",
        help="dump stage artifacts (seed/final clouds, occupancy grids) "
        "— the reference's DEBUG_PMVS_* CMake flags as a runtime option",
    )
    p.add_argument(
        "--profile-dir", help="write a jax.profiler trace of the run here"
    )
    p.add_argument(
        "--distributed",
        action="store_true",
        help="run over all devices (single- or multi-host); with "
        "--coordinator/--num-processes/--process-id, joins a "
        "jax.distributed job first",
    )
    p.add_argument("--coordinator", help="multi-host coordinator host:port")
    p.add_argument(
        "--num-processes", type=int, help="multi-host process count"
    )
    p.add_argument("--process-id", type=int, help="this process's id")
    p.add_argument(
        "--partition",
        choices=["replicated", "clustered"],
        default="replicated",
        help="multi-host image partitioning: 'replicated' (SPMD patch "
        "sharding, full image stack per process — DTU-scale default) or "
        "'clustered' (covisibility view clusters, each process holds only "
        "its cluster's images + halo — pod-scale scenes)",
    )
    p.add_argument(
        "--halo-threshold",
        type=float,
        default=0.25,
        help="clustered partitioning: minimum covisibility for a "
        "non-member view to be held by a cluster's process",
    )
    p.add_argument(
        "--local-device-ids",
        help="multi-process on one host: comma-separated local GPU ids "
        "this process owns (one card per process, e.g. its process id)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.settings:
        import json as _json

        with open(args.settings) as f:
            settings = _json.load(f)
    else:
        settings = {}
    if args.profile:
        settings["profile"] = args.profile
    config = load_config(settings) if settings else PipelineConfig()
    runtime_overrides = {
        key: value
        for key, value in (
            ("checkpoint_dir", args.checkpoint_dir),
            ("resume", args.resume),
            ("debug_dir", args.debug_dir),
            ("profile_dir", args.profile_dir),
        )
        if value
    }
    if runtime_overrides:
        import dataclasses

        config = config.replace(
            runtime=dataclasses.replace(config.runtime, **runtime_overrides)
        )

    if args.coordinator or args.num_processes:
        # MUST happen before any jax call that initializes the backend
        # (load_scene builds device camera arrays).
        from densepoints.parallel.multihost import initialize_multihost

        initialize_multihost(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            local_device_ids=(
                [int(i) for i in args.local_device_ids.split(",")]
                if args.local_device_ids
                else None
            ),
        )
    else:
        # Persistent compilation cache: every cold start recompiles every
        # stage otherwise. In multi-process jobs initialize_multihost
        # wires it after distributed init.
        from densepoints.utils.cache import enable_compilation_cache

        enable_compilation_cache()

    from densepoints.io.scene import load_scene

    scene = load_scene(args.input)
    log.info("scene: %d views", scene.cameras.num_views)
    if args.partition == "clustered":
        from densepoints.parallel.clustered import densify_clustered

        result = densify_clustered(
            scene, config, halo_threshold=args.halo_threshold
        )
    elif args.distributed or args.coordinator:
        from densepoints.parallel.multihost import densify_multihost

        result = densify_multihost(scene, config)
    else:
        from densepoints.pmvs.pipeline import densify

        result = densify(scene, config)
    import jax

    if jax.process_index() == 0:
        result.save_ply(args.output, binary=not args.ascii)
        log.info("wrote %d points to %s", len(result.positions), args.output)

    # Mesh extraction/write only on process 0: in a multi-host job every
    # process reaches here and concurrent writes to one path would corrupt
    # it on shared filesystems (ADVICE r2).
    if args.mesh and jax.process_index() == 0:
        from densepoints.surface.tsdf import extract_surface

        verts, faces = extract_surface(
            result.positions, result.normals, config.surface
        )
        from densepoints.io.ply import write_mesh_ply

        write_mesh_ply(args.mesh, verts, faces)
        log.info(
            "wrote mesh with %d vertices / %d faces to %s",
            len(verts),
            len(faces),
            args.mesh,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
