"""A rehearsal of ``run.py``'s control flow on the CPU at a tiny size, the
kernels' plain versions in the program's place, through the test-only
entry ``run.run(..., rehearsal=...)``; and the real entry refusing what it
must refuse."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import run
from harness.manifest import BENCH_DIR, ROOT, Manifest

SIZE = (12, 16)
CELLS = [w["name"] for w in Manifest.load().data["workloads"]]


def rehearse(cell, seed=2147483651, size=SIZE):
    return run.run(["--workload", cell, "--seed", str(seed), "--seconds",
                    "0.5"], rehearsal={"size": size})


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses_correct(cell):
    r = rehearse(cell)
    want = {m["name"] for m in Manifest.load().cell(cell).end_to_end}
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert r["setup_phases_s"]["checked_units"] > 0
    assert r["device"]["platform"] == "cpu"


def test_traced_rehearsal_has_no_device_numbers():
    """A CPU trace has no device activity, so no reader reports."""
    r = run.run(["--workload", CELLS[0], "--seed", "5",
                 "--seconds", "0.5", "--trace", "1"],
                rehearsal={"size": SIZE})
    assert r["correct"] is True
    assert r["metrics"] == {}
    assert r["device"]["busy_s"] == 0


def _bench(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def _no_result(out: subprocess.CompletedProcess) -> bool:
    lines = out.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _bench(["--workload", CELLS[0], "--seed", "1",
                  "--seconds", "1"], ROOT, env)
    assert out.returncode != 0 and _no_result(out)


def test_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench(["--workload", CELLS[0], "--seed", "1",
                  "--seconds", "1"], tmp_path)
    assert out.returncode != 0 and _no_result(out)


def test_the_result_line_is_last(monkeypatch, capsys):
    monkeypatch.setattr(run, "run", lambda argv=None: {
        "correct": True, "attempted": 1, "failed": 0, "metrics": {},
        "device": {}, "checks": {"mismatch": {"value": 0.0,
                                              "limit": 1e-3}}})
    assert run.main([]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
    assert err.strip().splitlines()[-1].startswith("check mismatch")


def test_jax_in_the_process_is_refused(monkeypatch):
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "romis_tpu_torch_extra", object())
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "romis_tpu.render", object())
    assert "romis_tpu" in run.forbidden_modules()
