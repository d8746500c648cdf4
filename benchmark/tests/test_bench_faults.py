"""With the timed path broken underneath, a whole run (on the CPU, the
card's look skipped through the test-only rehearsal entry) reports
``correct`` false: once for each fault a cell can have (``faults.py``), as
its traffic file lists them (an R-OMIS frame carries no state, so it
cannot leave one unchanged)."""

import pytest

import faults
import run
from harness.manifest import Manifest

SIZE = (12, 16)
CASES = [(w["name"], f) for w in Manifest.load().data["workloads"]
         for f in Manifest.load().cell(w["name"]).traffic["faults"]]


def test_every_fault_a_cell_lists_is_known():
    assert CASES and all(f in faults.FAULTS for _, f in CASES)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    man = Manifest.load()
    drive = man.drive(man.cell(cell).traffic["drive"])
    built = drive.Drive

    def broken(*a, **k):
        return faults.plant(built(*a, **k), fault)

    monkeypatch.setattr(drive, "Drive", broken)
    r = run.run(["--workload", cell, "--seed", "2147483659", "--seconds",
                 "0.2"], rehearsal={"size": SIZE})
    assert r["correct"] is False, r["checks"]
    assert r["failed"] > 0


def test_unknown_fault_is_refused():
    with pytest.raises(ValueError):
        faults.plant(object(), "nothing")
