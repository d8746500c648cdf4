"""A traced window, reduced to what the per-layer readers take.

``torch.profiler`` traces the host's operations and the device's kernels,
copies and sets over the traced units. The device is busy where any of its
activities runs (the union of their intervals); the window is the host's
clock from the first unit's dispatch to the synchronisation after the
last. An idle gap is named by the innermost host operation running at its
middle.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

PORT_KERNEL = "romis::"  # the namespace of the port's CUDA kernels


@dataclass
class Trace:
    units: int
    window_s: float
    busy_s: float
    device_ops: dict  # name → [seconds, count]
    idle_gaps: list  # [[host op, seconds]], longest first
    context: dict = field(default_factory=dict)

    def kernel_s(self, match) -> float:
        """Device seconds in the activities whose name ``match`` accepts."""
        return sum(s for n, (s, _) in self.device_ops.items() if match(n))

    def kernel_count(self, match) -> int:
        return sum(c for n, (_, c) in self.device_ops.items() if match(n))


def is_kernel(name: str) -> bool:
    """A kernel launch, not a copy or a set."""
    return not name.startswith(("Memcpy", "Memset"))


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_op_at(cpu, t):
    best = None
    for a, b, name in cpu:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return "(no host operation)" if best is None else best[2]


def capture(unit, n: int, sync, cuda: bool, n_gaps: int = 10) -> Trace:
    """Trace ``n`` calls of ``unit``, then ``sync()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            unit()
        sync()
        window = time.perf_counter() - t0
    ops, dev, cpu = {}, [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end  # microseconds
        if e.device_type == DeviceType.CUDA:
            dev.append((a, b))
            s, c = ops.get(e.name, (0.0, 0))
            ops[e.name] = [s + (b - a) * 1e-6, c + 1]
        elif e.device_type == DeviceType.CPU:
            cpu.append((a, b, e.name))
    merged = _union(dev)
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:n_gaps]
    idle = [[_host_op_at(cpu, (a + b) / 2), g * 1e-6] for g, a, b in gaps]
    return Trace(units=n, window_s=window, busy_s=busy, device_ops=ops,
                 idle_gaps=idle)


def breakdown(trace: Trace, n: int = 10) -> dict:
    top = sorted(trace.device_ops.items(), key=lambda kv: -kv[1][0])[:n]
    return {"device_ops": [[k, v[0]] for k, v in top],
            "idle_gaps": trace.idle_gaps[:n]}
