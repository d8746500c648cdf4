"""Faults planted under the timed path, to show that ``correct`` catches
them (``tests/test_bench_faults.py`` on the CPU, ``calibrate.py --fault``
on the card).

- ``state_unchanged``: a unit that leaves the drive's state as it found
  it (a frame's temporal state not carried);
- ``half_batch``: half of the work left out (the lower half of a frame's
  rows not rendered);
- ``answer_altered``: the answer altered where it is produced (a frame's
  image scaled by 0.99).

One card runs the cells, so no exchange between cards can be left out.
"""

from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered")
SCALE = 0.99


def plant(drive, fault: str):
    """Make ``drive``'s units run with ``fault`` (the instance only)."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    unit = drive.unit

    def broken():
        if fault == "state_unchanged":
            keep = drive.state
            out = unit()
            drive.state = keep
            return out
        img = unit()
        if fault == "answer_altered":
            return img * SCALE
        h = img.shape[0]
        return torch.cat([img[:h // 2], torch.zeros_like(img[h // 2:])])

    drive.unit = broken
    return drive
