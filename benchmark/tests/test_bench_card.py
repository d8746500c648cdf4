"""On the card: the program's first frames and steps against the reference
at a reduced size, the kernels' own Philox draws made again by
``reference.draws`` (``python -m pytest benchmark/tests -m chip``)."""

import pytest

import run
from harness.manifest import Manifest


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  Manifest.load().data["workloads"]])
def test_cell_on_the_card_is_correct(card, cell, monkeypatch):
    monkeypatch.setattr(run, "HostRehearsal",
                        lambda torch: run.Card(torch))
    r = run.run(["--workload", cell, "--seed", "2147483677", "--seconds",
                 "1"], rehearsal={"size": (96, 160)})
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu"
