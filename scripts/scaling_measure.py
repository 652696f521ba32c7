"""Measured multi-process scaling vs the SCALING model (VERDICT r4 #7).

Runs the REAL multihost driver at 1/2/4 gloo processes over a FIXED
8-virtual-CPU-device mesh and a fixed workload, and reconciles the
measured per-round fixed costs against the `T(N) = t_device/N + t_fixed`
model of scripts/scaling_overhead.py. Because total devices are fixed,
the device-work term is constant across process counts; the wall delta
vs 1 process IS the distribution fixed cost (gloo collectives, per-round
replicated host pulls, coordination) — the term the model previously
assumed.

Caveat recorded in the artifact: this host has 2 physical cores, so
multi-process runs are CPU-contended; the honest comparison is the
per-round host-sync/overhead columns (timed around the collectives
themselves), with the contended wall reported alongside.

Usage: python scripts/scaling_measure.py [--out scaling_measured.json]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_job(nproc: int, seeds: int, tmp: Path) -> dict:
    worker = Path(__file__).parent / "scaling_worker.py"
    port = _free_port()
    out = tmp / f"scaling_{nproc}.json"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), str(nproc), str(port),
             str(out), str(seeds)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(nproc)
    ]
    logs = [p.communicate(timeout=1800)[0].decode() for p in procs]
    for p, tail in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(
                f"scaling worker failed (nproc={nproc}):\n{tail[-3000:]}"
            )
    job_wall = time.perf_counter() - t0
    data = json.load(open(out))
    data["job_wall_seconds"] = round(job_wall, 2)
    return data


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="scaling_measured.json")
    p.add_argument("--seeds", type=int, default=2500)
    p.add_argument("--tmp", default="/tmp/scaling_measure")
    args = p.parse_args(argv)
    tmp = Path(args.tmp)
    tmp.mkdir(parents=True, exist_ok=True)

    runs = {}
    for nproc in (1, 2, 4):
        runs[nproc] = run_job(nproc, args.seeds, tmp)
        print(nproc, runs[nproc], flush=True)

    base = runs[1]
    rounds = 3
    rows = []
    for nproc, r in runs.items():
        sync = float(r["counters"].get("overhead_host_sync_s", 0.0))
        rows.append(
            {
                "nproc": nproc,
                "wall_seconds": r["wall_seconds"],
                "expand_seconds": r["stage_seconds"].get("expand"),
                "host_sync_seconds_total": round(sync, 4),
                "host_sync_per_round": round(sync / rounds, 4),
                "fixed_cost_vs_1proc_seconds": round(
                    r["wall_seconds"] - base["wall_seconds"], 2
                ),
                "patches_after_expand": r["counters"].get(
                    "patches_after_expand"
                ),
                "patches_final": r["counters"].get("patches_final"),
            }
        )

    artifact = {
        "protocol": "fixed 8-device virtual mesh, fixed workload; process "
        "count varies -> device term constant, wall delta = distribution "
        "fixed cost (2-core host: multi-process walls are CPU-contended; "
        "host_sync columns are timed around the collectives themselves)",
        "seeds": args.seeds,
        "rounds": rounds,
        "measured": rows,
        "model_reference": "scripts/scaling_overhead.py per_round (t_fixed = "
        "host_sync 0.495 s/round at DTU scale; this workload's own "
        "host_sync_per_round column is the measured analog)",
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print("wrote", args.out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
