"""The readings a cell's limits are set from, in one process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault <name> --fault-seeds 1,2,3]

For each seed it runs the program's checked units as a run's set-up does
(no window), then the reference's, and prints the compared numbers (the
lower reading is the largest over sound seeds); for each control seed the
reference computed in bfloat16 in the program's place (the upper reading
is the smallest); for each fault seed the program with a planted fault
(``faults.py``). One JSON object a line; a summary last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run  # noqa: F401  (the run's caches and import paths)


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from harness.manifest import Manifest

    import faults

    man = Manifest.load(run.ROOT)
    cell = man.cell(args.workload)
    card = run.require_card(torch, cell.chips)
    tr, dev = cell.traffic, card.device
    n = int(tr["check_units"])
    drive_mod, ref = man.drive(tr["drive"]), man.reference(tr["reference"])

    def reference(seed, control=False):
        return ref.expected(cell.config, tr, seed % 2 ** 63, dev, n,
                            control=control)

    def program_units(seed, fault=None):
        d = drive_mod.Drive(cell.config, tr, seed % 2 ** 63, dev)
        if fault:
            faults.plant(d, fault)
        for _ in range(n):
            d.check_unit()
        got = d.result()
        d.free()
        del d
        card.free()
        return got

    rows = []

    def emit(kind, seed, nums, t0):
        row = {"kind": kind, "seed": seed, "numbers": nums,
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)

    refs = {}
    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        got = program_units(seed)
        refs[seed] = reference(seed)
        emit("program", seed, ref.numbers(got, refs[seed]), t0)
    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        want = refs.get(seed) or reference(seed)
        emit("control", seed, ref.numbers(reference(seed, control=True),
                                          want), t0)
    if args.fault:
        for seed in _seeds(args.fault_seeds):
            t0 = time.perf_counter()
            got = program_units(seed, args.fault)
            want = refs.get(seed) or reference(seed)
            emit(f"fault:{args.fault}", seed, ref.numbers(got, want), t0)
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        nums = [r["numbers"] for r in rows if r["kind"] == kind]
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(x[k] for x in nums) for k in nums[0]}
    print(json.dumps({"summary": summary, "workload": args.workload,
                      "device": card.describe(cell.chips)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
