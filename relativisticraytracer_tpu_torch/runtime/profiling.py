"""Tracing / profiling / per-frame stats (port of
relativisticraytracer_tpu.runtime.profiling).

The reference's only instrumentation is a 1 Hz FPS title-bar counter
(src/main.cpp:438-458). Here:
  * `FrameTimer` — named wall-clock stages with a one-line report;
  * `march_stats` — per-frame ray outcome counts (captured / escaped /
    step-cap saturated) from the plain march's state
    (render/march.MarchState);
  * `trace` — context manager around `torch.profiler` (host and CUDA
    activity) that writes a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Dict, Optional

import torch


class FrameTimer:
    """Accumulates named stage timings; thread-unsafe by design (per loop)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        parts = []
        for name, total in sorted(self.totals.items()):
            n = max(1, self.counts[name])
            parts.append(f"{name}: {total / n * 1000:.2f} ms/it (n={n})")
        return " | ".join(parts) if parts else "(no stages timed)"

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


def march_stats(state) -> Dict[str, float]:
    """Ray-outcome summary from a MarchState: fraction captured by the
    horizon, escaped to infinity, and still active at the step cap (the
    rays that paid for MAX_STEPS; the early-exit win shrinks with this)."""
    hit = state.hit_horizon
    n = hit.numel()
    captured = float(hit.sum()) / n
    saturated = float(state.active.sum()) / n
    return {
        "rays": n,
        "captured": captured,
        "saturated": saturated,
        "escaped": 1.0 - captured - saturated,
        "mean_transmittance": float(state.transmittance.float().mean()),
    }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler trace of the block, host and CUDA activity, written
    as a Chrome trace (`trace.json`) into `log_dir`; yields the profiler.
    A no-op when log_dir is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
