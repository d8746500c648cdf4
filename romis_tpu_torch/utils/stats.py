"""Frame statistics, ray accounting, a phase timer and a JSONL log
(reference ``romis_tpu/utils/stats.py``).

``PhaseTimer`` times a phase with CUDA events recorded around it on a CUDA
device (the device's own clock, read after the end event completes) and
with ``time.perf_counter`` on the CPU; the device it is given decides.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import torch

from ..core.features import Features


def frame_ray_counts(height: int, width: int, features: Features) -> dict:
    """Per-frame ray and reservoir-update accounting of the ReSTIR frame
    (the reference's loops, render.cpp:28-62): the unbiased combine's
    visibility check traces passes x (R+1) x K Z rays a pixel."""
    n = height * width
    k = features.num_samples_in_reservoir
    primary = n
    final_shadow = n * k
    init_vis = n * k if features.initial_samples_visibility_check else 0
    unbiased_vis = 0
    if (features.spatial_reuse and features.unbiased_combination
            and features.spatial_reuse_visibility_check):
        unbiased_vis = (n * features.spatial_resampling_passes
                        * (features.num_neighbours_to_sample + 1) * k)
    reservoir_updates = n * features.initial_light_samples
    if features.temporal_reuse:
        reservoir_updates += n * 2 * k
    if features.spatial_reuse:
        reservoir_updates += (n * features.spatial_resampling_passes
                              * (features.num_neighbours_to_sample + 1) * k)
    return {
        "primary_rays": primary,
        "shadow_rays": final_shadow + init_vis + unbiased_vis,
        "total_rays": primary + final_shadow + init_vis + unbiased_vis,
        "reservoir_updates": reservoir_updates,
        "target_pdf_evals": n * (
            features.initial_light_samples
            + (2 * k + k if features.temporal_reuse else 0)
            + (features.spatial_resampling_passes
               * ((features.num_neighbours_to_sample + 1) * k + k)
               if features.spatial_reuse else 0)),
    }


def reservoir_stats(reservoirs) -> dict:
    """Summary of a reservoir grid (6 scalars)."""
    total_m = reservoirs.total_m()
    return {
        "m_mean": float(total_m.mean()),
        "m_max": float(total_m.max()),
        "w_mean": float(reservoirs.big_w.mean()),
        "w_max": float(reservoirs.big_w.max()),
        "w_sum_mean": float(reservoirs.w_sum.mean()),
        "zero_w_frac": float((reservoirs.big_w == 0.0).float().mean()),
    }


@dataclass
class PhaseTimer:
    """Accumulates the seconds of named phases on ``device``.

    Usage:
        timer = PhaseTimer(device)
        with timer("trace"):
            out = traced_fn(...)
        print(timer.report())
    """

    device: torch.device | str = "cpu"
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    _current: str | None = None
    _start: object = None

    def __call__(self, name: str):
        self._current = name
        return self

    def _cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def __enter__(self):
        if self._cuda():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda():
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._start
        name = self._current or "?"
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return False

    def report(self) -> str:
        return "\n".join(
            f"{name}: {total:.3f}s total, "
            f"{1000 * total / max(self.counts[name], 1):.1f} ms/call "
            f"({self.counts[name]} calls)"
            for name, total in sorted(self.totals.items(),
                                      key=lambda kv: -kv[1]))


class JsonlLogger:
    """Appends one JSON record per line to a file."""

    def __init__(self, path: str):
        self.path = path

    def log(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
