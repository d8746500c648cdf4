"""Every place where a frame of a benchmark cell makes the host wait for
the card, found by ``torch.cuda.set_sync_debug_mode("warn")``.

    python3 scripts/torch_sync_sites.py [--cells a,b] [--frames N]
        [--seed S] [--cpu]

Each cell's drive (``benchmark/drives``) is built on its configuration,
warmed by its check and warm frames, then ``--frames`` frames run with the
mode set; each warning is keyed by the innermost frames of the program on
the Python stack, and the sites are printed with their count a frame.
Every site should be a ``romis.sync.*`` span (``utils.stats``). ``--cpu``
rehearses the control flow at 12 x 16 on the CPU, where nothing syncs.
"""

from __future__ import annotations

import argparse
import sys
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "benchmark"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def sites(torch, unit, frames: int, depth: int = 4) -> Counter:
    """{the program's innermost stack frames: warnings} over ``frames``
    calls of ``unit``."""
    found = Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        stack = [f for f in traceback.extract_stack()[:-1]
                 if "romis_tpu_torch" in f.filename]
        found[" <- ".join(
            f"{Path(f.filename).relative_to(ROOT)}:{f.lineno} {f.name}"
            for f in reversed(stack[-depth:]))
            or f"{filename}:{lineno} ({str(message)[:120]})"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(frames):
                unit()
        finally:
            if torch.cuda.is_available():
                torch.cuda.set_sync_debug_mode(0)
    return found


def main(argv=None) -> int:
    import torch

    from harness.manifest import Manifest

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--seed", type=int, default=3000000019)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    manifest = Manifest.load(ROOT)
    cells = args.cells.split(",") if args.cells else [
        w["name"] for w in manifest.data["workloads"]]
    device = torch.device("cpu" if args.cpu else "cuda")
    size = (12, 16) if args.cpu else None
    for name in cells:
        cell = manifest.cell(name)
        tr = cell.traffic
        drive = manifest.drive(tr["drive"]).Drive(cell.config, tr, args.seed,
                                                  device, size)
        for _ in range(int(tr["check_units"]) + int(tr["warm_units"])):
            drive.unit()
        if device.type == "cuda":
            torch.cuda.synchronize()
        found = sites(torch, drive.unit, args.frames)
        total = sum(found.values()) / args.frames
        print(f"{name}: {total:g} synchronising calls a frame over "
              f"{args.frames} frames")
        for key, n in found.most_common():
            print(f"{name}:   {n / args.frames:g} a frame at {key}")
        drive.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
