"""Structured logging + per-stage timers/counters.

The reference logs via easylogging++ macros and counts progress in log lines
(expand.cpp:91-93). Here: stdlib logging plus a tiny metrics registry that
each pipeline stage updates (keypoints/view, matches/pair, seeds, accept
rates, patches/sec) — the observability the reference lacks (SURVEY.md §5.5).
"""
from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("densepoints")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    log.addHandler(_h)
    log.setLevel(logging.INFO)


class StageMetrics:
    """Accumulates per-stage wall times and counters for one pipeline run."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counters: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - start
            )

    def count(self, name: str, value: float):
        self.counters[name] = value

    def summary(self) -> str:
        parts = [f"{k}={v:.3f}s" for k, v in self.times.items()]
        parts += [f"{k}={v:g}" for k, v in self.counters.items()]
        return " ".join(parts)
