"""Run one cell of the benchmark of ``romis_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the program's drive (``drives/<drive>.py``, named by the
cell's traffic file) on the cell's configuration, runs the checked units
and a few more to warm every kernel, then the window: units back to back
for ``--seconds`` (``--trace 0``: the end-to-end metrics) or a traced
window of the traffic's ``trace_units`` (``--trace 1``: the per-layer
metrics). After the window the program is freed and the plain reference
the traffic file names (``reference/<reference>.py``) computes the checked
units again from the seed; ``correct`` holds when every compared number is
within its limit. The last line of standard output is the result as one
JSON object; the set-up's phases and the compared numbers go to standard
error, the numbers last.

It runs on the CUDA card it is started on and refuses to run without one.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the wall clock (from /proc where it can)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
T_TOP = time.time()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "romis_tpu")

# Every build and kernel cache of the run stays at a fixed path inside the
# checkout (the port's own library lands in build/romis_tpu_torch/).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "benchmark" / sub)
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def parse(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


class Card:
    """The CUDA device the run measures: events at unit boundaries."""

    def __init__(self, torch, index: int = 0):
        self.torch = torch
        self.device = torch.device("cuda", index)
        self.cuda = True

    def start(self):
        """The CUDA context, made before the program is built."""
        self.torch.cuda.init()
        self.torch.zeros(1, device=self.device).sum().item()

    def mark(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sync(self):
        self.torch.cuda.synchronize()

    def gaps_ms(self, marks):
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    def reset_peak(self):
        self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated())

    def describe(self, chips: int) -> dict:
        return {"platform": "gpu",
                "kind": self.torch.cuda.get_device_name(0),
                "count": chips, "power_limit": power_limit()}

    def free(self):
        self.torch.cuda.empty_cache()


class HostRehearsal(Card):
    """A rehearsal of the control flow on the CPU (tests only): the host's
    clock at unit boundaries, no device memory, no device trace."""

    def __init__(self, torch):
        self.torch = torch
        self.device = torch.device("cpu")
        self.cuda = False

    def start(self):
        pass

    def mark(self):
        return time.perf_counter()

    def sync(self):
        pass

    def gaps_ms(self, marks):
        return [1e3 * (b - a) for a, b in zip(marks, marks[1:])]

    def reset_peak(self):
        pass

    def peak(self) -> int:
        return 0

    def describe(self, chips: int) -> dict:
        return {"platform": "cpu", "kind": "cpu rehearsal", "count": chips}

    def free(self):
        pass


def require_card(torch, chips: int) -> Card:
    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA device; this benchmark measures the "
                 "card and does not run on the CPU")
    if torch.cuda.device_count() < chips:
        sys.exit(f"benchmark: the cell asks for {chips} CUDA devices, "
                 f"{torch.cuda.device_count()} present")
    return Card(torch)


def window_stats(units: int, window_s: float, gaps_ms, peak: int) -> dict:
    """The window's statistics an end-to-end metric may name."""
    import numpy as np

    return {"rate_ms": 1e3 * window_s / units,
            "p95_ms": float(np.percentile(gaps_ms, 95)),
            "peak_gib": peak / 2 ** 30}


def run(argv=None, rehearsal=None) -> dict:
    """One run → the result object. ``rehearsal`` (tests only) replaces
    the card: {"size": (h, w)} runs on the CPU at that size."""
    args = parse(argv)
    phases = {"interpreter": T_TOP - T_START}
    mark = time.time()
    import torch

    phases["torch_import"] = time.time() - mark
    mark = time.time()
    from harness import trace
    from harness.manifest import Manifest

    phases["harness_import"] = time.time() - mark
    manifest = Manifest.load(ROOT)
    cell = manifest.cell(args.workload)
    tr = cell.traffic
    card = HostRehearsal(torch) if rehearsal is not None \
        else require_card(torch, cell.chips)
    size = None if rehearsal is None else tuple(rehearsal["size"])
    seed = args.seed % 2 ** 63
    mark = time.time()
    card.start()
    phases["card"] = time.time() - mark
    mark = time.time()
    drive = manifest.drive(tr["drive"]).Drive(cell.config, tr, seed,
                                              card.device, size)
    phases["program"] = time.time() - mark
    n_check, n_warm = int(tr["check_units"]), int(tr["warm_units"])
    mark = time.time()
    for _ in range(n_check):
        drive.check_unit()
    card.sync()
    phases["checked_units"] = time.time() - mark
    mark = time.time()
    for _ in range(n_warm):
        drive.unit()
    card.sync()
    phases["warm_units"] = time.time() - mark
    setup_s = time.time() - T_START
    setup_peak = card.peak()

    card.reset_peak()
    metrics, result_extra = {}, {}
    if args.trace:
        tc = trace.capture(drive.unit, int(tr["trace_units"]), card.sync,
                           card.cuda)
        units = tc.units
    else:
        marks = [card.mark()]
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            drive.unit()
            marks.append(card.mark())
        card.sync()
        window_s = time.perf_counter() - t0
        units = len(marks) - 1
        stats = window_stats(units, window_s, card.gaps_ms(marks),
                             card.peak())
        stats["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": stats[tr["end_to_end"][
                m["name"]]], "unit": m["unit"]}
    device = card.describe(cell.chips)
    device["memory_peak_bytes"] = max(setup_peak, card.peak())
    if args.trace:
        device["busy_s"], device["window_s"] = tc.busy_s, tc.window_s

    got = drive.result()
    drive.free()
    del drive
    card.free()
    ref = manifest.reference(tr["reference"])
    want = ref.expected(cell.config, tr, seed, card.device, n_check, size)
    checks = judge(ref.numbers(got, want), cell.limits)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if args.trace:
        tc.context = ref.context(cell.config, tr, card.device, size)
        for m in cell.per_layer:
            value = manifest.reader(m["name"]).read(tc)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_extra["breakdown"] = trace.breakdown(tc)

    bad = forbidden_modules()
    if bad:
        sys.exit(f"benchmark: the process loaded {', '.join(bad)}")
    return {"correct": correct, "attempted": units,
            "failed": 0 if correct else n_check, "metrics": metrics,
            "device": device, **result_extra, "setup_phases_s": phases,
            "checks": checks}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limited number (a number
    without a limit is a fault of the cell's files)."""
    return {n: {"value": numbers[n], "limit": limits[n]} for n in limits}


def main(argv=None) -> int:
    import json

    result = run(argv)
    print("setup phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in result.get("setup_phases_s", {}).items()),
        file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
