"""Frame statistics and ray accounting (reference
``romis_tpu/utils/stats.py``), the renderer's spans and its kernel launch
counts.

**Spans.** ``span(name, device)`` marks a phase of a frame. Spans record
only while ``torch.profiler`` runs (``torch.autograd.profiler.
_is_profiler_enabled``); otherwise ``span`` returns one shared no-op
context: no allocation, no event, no clock read. While the profiler runs,
a span

- opens ``torch._C._profiler._RecordFunctionFast(name)``: a CPU operation
  on the profiler's clock beside the kernels, which names the device's
  idle gaps, and never a device event (``record_function`` would add a
  ``gpu_user_annotation`` to the device's timeline, which a trace reader
  counts as device activity);
- appends a ``Span`` to the records: its name, the enclosing span's index
  (on the same thread), the frame it lies in (each ``FRAME`` span begins
  the next), and its host start and end (``time.perf_counter_ns``);
- given a CUDA ``device``, records a timing event pair around it on the
  device's current stream. Nothing waits on the pair inside the frame:
  ``records()`` reads it, after the caller's own synchronisation. The
  pair times the span's extent on the device's timeline, from the first
  of its work the device reaches to the last, idle between included (on
  a host-paced frame, the device waiting for the host's enqueue). Only a
  span that a metric reads as device time is given a device.

``records()`` → the spans, each with its device milliseconds (None without
a pair); ``clear()`` empties them. The records hold one profiling session:
the first root ``FRAME`` span that opens after a span ran with the
profiler off clears them, as does one that finds ``MAX_RECORDS`` already
held. A caller that profiles on a schedule reads them once a cycle (in
``on_trace_ready``), and one that wants no records held calls ``clear()``.
The names (``PERF.md`` lists the metric each feeds): ``FRAME``
(``render.pipeline.render_frame``, the root of every frame); in a ReSTIR
frame ``romis.trace``, ``romis.ris``, ``romis.temporal`` (timed on the
device), ``romis.spatial``, ``romis.shade``; in an R-MIS or R-OMIS frame
``romis.select``, one ``romis.mis_iter`` an iteration and
``romis.alpha_solve`` for each α solve (timed on the device); and
``SYNC`` + the site for each
place where a frame makes the host wait for the device
(``romis.sync.camera``: the camera's copy from pageable memory;
``romis.sync.ris_key``: the kernels' Philox key; ``romis.sync.mis_seeds``:
the differentiable MIS iterations' seeds). ``scripts/torch_sync_sites.py``
finds such places on the card.

**Launch counts.** ``launches`` counts the kernels launched, by C entry
point (``ops._build.launch``; ``name:mode`` where one entry runs two
kernels), profiler or not; a caller clears it and reads it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _profiler

from ..core.features import Features

FRAME = "romis.frame"
SYNC = "romis.sync."

launches: dict[str, int] = {}


@dataclass
class Span:
    """One recorded span: ``parent`` is the enclosing span's index in
    ``records()`` (None at the top), ``frame`` the count of ``FRAME``
    spans begun when it began; times from ``time.perf_counter_ns``."""

    name: str
    parent: int | None
    frame: int
    start_ns: int = 0
    end_ns: int = 0
    device_ms: float | None = None
    events: tuple | None = field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


MAX_RECORDS = 1 << 17  # ~10,000 ReSTIR frames' spans

_records: list[Span] = []
_local = threading.local()  # .open: the indices of the open spans
_frame = 0
_off_ran = False  # a span ran with the profiler off since the last clear

_OFF = contextlib.nullcontext()  # shared: it keeps no state


class _On:
    __slots__ = ("name", "device", "rec", "index", "fast")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self) -> Span:
        global _frame
        stack = getattr(_local, "open", None)
        if not stack:
            if self.name == FRAME and (_off_ran
                                       or len(_records) >= MAX_RECORDS):
                clear()
            stack = _local.open = []
        if self.name == FRAME:
            _frame += 1
        self.index = len(_records)
        self.rec = Span(self.name, stack[-1] if stack else None, _frame)
        _records.append(self.rec)
        stack.append(self.index)
        self.fast = torch._C._profiler._RecordFunctionFast(self.name)
        self.fast.__enter__()
        if self.device is not None and self.device.type == "cuda":
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record(torch.cuda.current_stream(self.device))
            self.rec.events = pair
        self.rec.start_ns = time.perf_counter_ns()
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.perf_counter_ns()
        if self.rec.events is not None:
            self.rec.events[1].record(torch.cuda.current_stream(self.device))
        self.fast.__exit__(*exc)
        stack = _local.open
        if stack and stack[-1] == self.index:
            stack.pop()
        return False


def span(name: str, device: torch.device | None = None):
    """A context that records the span ``name`` while the profiler runs,
    timed on ``device``'s clock too when it is a CUDA device."""
    global _off_ran
    if not _profiler._is_profiler_enabled:
        _off_ran = True
        return _OFF
    return _On(name, device)


def records() -> list[Span]:
    """The spans recorded since they were last cleared, each closed one's
    device milliseconds read from its event pair (waiting for the pair's
    end)."""
    for rec in _records:
        if rec.events is not None and rec.end_ns:
            start, end = rec.events
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
            rec.events = None
    return list(_records)


def clear() -> None:
    global _frame, _off_ran
    _records.clear()
    _local.open = []
    _frame = 0
    _off_ran = False


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
