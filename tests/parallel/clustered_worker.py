"""Subprocess worker for the cluster-partitioned multi-host CPU test.

Each process joins the jax.distributed job, holds ONLY its cluster's
images + halo (asserted), and must produce the same final cloud as every
other process — and, with a permissive halo, the same cloud (count-exact,
5e-3 positions: the cross-batch-shape contract, docs/ROUND4_NOTES.md) as
a 1-process run.

Usage: python clustered_worker.py <pid> <nproc> <port> <out.npz> <halo_thr>
"""
import os
import sys

pid, nproc, port, out, halo_thr = (
    int(sys.argv[1]),
    int(sys.argv[2]),
    sys.argv[3],
    sys.argv[4],
    float(sys.argv[5]),
)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from densepoints.parallel.multihost import initialize_multihost  # noqa: E402

initialize_multihost(
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
    platform="cpu",
)

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from densepoints.config import PipelineConfig  # noqa: E402
from densepoints.core import Cameras  # noqa: E402
from densepoints.io.scene import Scene  # noqa: E402
from densepoints.parallel.clustered import densify_clustered  # noqa: E402
from synthetic import TexturedSphereScene  # noqa: E402

rng = np.random.default_rng(0)
# A sphere ringed by cameras: clusterable geometry (a plane's cameras all
# see everything; a ring partitions naturally into arcs).
sc = TexturedSphereScene(
    rng, num_views=8, width=200, height=150, focal=170.0,
    radius=1.0, cam_radius=4.0,
)
cams = Cameras.from_projection_matrices(
    sc.P, widths=sc.width, heights=sc.height
)
full_images = sc.render_all()
scene = Scene(cameras=cams, images=full_images, colors=None)
g = np.random.default_rng(7)
pts = g.standard_normal((60, 3)).astype(np.float32)
pts *= 1.0 / np.linalg.norm(pts, axis=1, keepdims=True)

cfg = PipelineConfig()
cfg = dataclasses.replace(
    cfg, expand=dataclasses.replace(cfg.expand, max_rounds=2)
)

loaded = {"views": None}


def loader(view_ids):
    loaded["views"] = np.asarray(view_ids)
    return full_images[view_ids]


res = densify_clustered(
    scene, cfg, seed_points=pts, halo_threshold=halo_thr,
    image_loader=loader,
)
held = loaded["views"]
assert held is not None
if nproc > 1 and halo_thr > 0.5:
    # A tight halo must actually shrink per-process image ownership.
    assert len(held) < cams.num_views, (
        f"process {pid} holds all {cams.num_views} views at thr={halo_thr}"
    )
np.savez(
    out,
    position=np.asarray(res.patches.position),
    normal=np.asarray(res.patches.normal),
    vis=np.asarray(res.patches.vis),
    views_held=held,
    image_bytes_held=res.metrics.counters["image_bytes_held"],
)
print(
    f"worker {pid}/{nproc}: {res.patches.capacity} patches, "
    f"holds {len(held)}/{cams.num_views} views",
    flush=True,
)
