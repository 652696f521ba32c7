"""Scaling-efficiency harness: refine throughput at 1..N devices.

BASELINE.md target: >= 0.7 scaling efficiency from 1 to N workers. Run on
real chips when available, or a virtual CPU mesh:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python scripts/scaling_bench.py

Prints one JSON line per device count plus the final efficiency summary.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _problem(num_patches, num_views=8, H=240, W=320):
    import jax.numpy as jnp

    from densepoints.core.cameras import Cameras
    from densepoints.pmvs.patch import PatchState

    rng = np.random.default_rng(0)
    K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]])
    Ps = []
    for i in range(num_views):
        ang = (i - (num_views - 1) / 2) * 0.12
        C = np.array([6.0 * np.sin(ang), 0.1 * i, -6.0 * np.cos(ang)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        Ps.append(K @ np.concatenate([R, (-R @ C)[:, None]], 1))
    cams = Cameras.from_projection_matrices(np.stack(Ps), widths=W, heights=H)
    images = jnp.asarray(rng.uniform(0, 255, (num_views, H, W)).astype(np.float32))
    xy = rng.uniform(-1.0, 1.0, (num_patches, 2))
    position = np.concatenate([xy, np.zeros((num_patches, 1))], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (num_patches, 1)).astype(np.float32)
    vis = np.ones((num_patches, num_views), bool)
    vis[:, 0] = False
    state = PatchState.create(
        position, normal, np.zeros(num_patches, np.int32), vis
    )
    return images, cams, state


def main():
    import jax
    import jax.numpy as jnp

    from densepoints.config import OptimizeConfig
    from densepoints.parallel.distributed import (
        distributed_refine_step,
        shard_state,
    )
    from densepoints.parallel.mesh import make_mesh

    total = len(jax.devices())
    counts = [c for c in (1, 2, 4, 8, 16) if c <= total]
    num_patches = 4096
    cfg = OptimizeConfig(max_iterations=20)
    images, cams, state = _problem(num_patches)

    results = {}
    for n in counts:
        mesh = make_mesh(n)
        sharded = shard_state(state, mesh)

        def step(s, seed):
            import dataclasses

            s2 = dataclasses.replace(s, position=s.position + seed * 1e-4)
            out = distributed_refine_step(images, cams, s2, 11, cfg)
            return jnp.sum(out.position)

        fn = jax.jit(step)
        float(fn(sharded, 0.0))  # compile
        t0 = time.perf_counter()
        float(fn(sharded, 1.0))
        dt = time.perf_counter() - t0
        pps = num_patches / dt
        results[n] = pps
        print(
            json.dumps(
                {"devices": n, "patches_per_sec": round(pps, 1)}
            ),
            flush=True,
        )
    if len(results) > 1:
        base = results[counts[0]]
        top = counts[-1]
        eff = results[top] / (base * top / counts[0])
        print(
            json.dumps(
                {
                    "metric": "scaling_efficiency",
                    "from_devices": counts[0],
                    "to_devices": top,
                    "value": round(eff, 3),
                }
            )
        )


if __name__ == "__main__":
    main()
