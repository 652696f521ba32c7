"""Subprocess worker for the multi-host CPU test.

Each process owns `devices_per_proc` virtual CPU devices and joins the
jax.distributed job; all processes run the SAME deterministic pipeline and
must produce the SAME cloud (SURVEY.md §4 "multi-host tests via
jax.distributed with multi-process CPU").

Usage: python multihost_worker.py <pid> <nproc> <port> <out.npz> [levels]
"""
import dataclasses
import os
import sys

pid, nproc, port, out = (
    int(sys.argv[1]),
    int(sys.argv[2]),
    sys.argv[3],
    sys.argv[4],
)
levels = int(sys.argv[5]) if len(sys.argv) > 5 else 1
devices_per_proc = 8 // nproc
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={devices_per_proc}"
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from densepoints.parallel.multihost import (  # noqa: E402
    densify_multihost,
    initialize_multihost,
)

initialize_multihost(
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
    platform="cpu",
)

import numpy as np  # noqa: E402

from densepoints.config import PipelineConfig  # noqa: E402
from densepoints.core import Cameras  # noqa: E402
from densepoints.io.scene import Scene  # noqa: E402
from synthetic import TexturedPlaneScene  # noqa: E402

rng = np.random.default_rng(0)
sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
cams = Cameras.from_projection_matrices(
    sc.P, widths=sc.width, heights=sc.height
)
scene = Scene(cameras=cams, images=sc.render_all(), colors=None)
xy = rng.uniform(-0.6, 0.6, (40, 2))
pts = np.concatenate([xy, np.zeros((40, 1))], 1).astype(np.float32)

cfg = PipelineConfig()
cfg = dataclasses.replace(
    cfg,
    expand=dataclasses.replace(cfg.expand, max_rounds=2),
    multiscale=dataclasses.replace(cfg.multiscale, levels=levels),
)
res = densify_multihost(scene, cfg, seed_points=pts)
np.savez(
    out,
    position=np.asarray(res.patches.position),
    normal=np.asarray(res.patches.normal),
    vis=np.asarray(res.patches.vis),
)
print(f"worker {pid}/{nproc}: {res.patches.capacity} patches", flush=True)
