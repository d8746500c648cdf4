"""``BENCHMARK.json`` keeps to its contract, and every name in it finds its
files: configurations, traffic mixes, drives, references, limits and
per-layer readers."""

import json
import re
import shutil

import pytest

from harness.manifest import BENCH_DIR, ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# A check's runs: 2 + 14 a cell at run_seconds + 60 each, 2 x 90 a cell to
# compile, 1200 spare, within 43200 s at the full 24 cells.
MAX_CELLS = 24


@pytest.fixture(scope="module")
def data():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level_and_entry_keys(data):
    assert set(data) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for section, (need, may) in KEYS.items():
        assert data[section], section
        for e in data[section]:
            assert need <= set(e) <= need | may, (section, e)


def test_names_units_and_lines(data):
    for section in KEYS:
        names = [e["name"] for e in data[section]]
        assert len(names) == len(set(names)), section
        for e in data[section]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
    for w in data["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in data["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_command_paths_and_length(data):
    assert 1 <= len(data["paths"]) <= 16
    for p in data["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = data["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in data["paths"])
    rs = data["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    full = (2 + 14 * MAX_CELLS) * (rs + 60) + MAX_CELLS * 180 + 1200
    assert full <= 43200


def test_metrics_and_cells(data):
    e2e = {m["name"]: m for m in data["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in data["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in data["workloads"]}
    assert len(cells) <= MAX_CELLS
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    assert {w["config"] for w in cells.values()} == {
        c["name"] for c in data["configs"]}
    man = Manifest(data)
    for name in cells:
        cell = man.cell(name)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, name
        assert cell.per_layer, name
    for m in data["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert m["moves"] in {x["name"] for x in man.cell(w).end_to_end}


def test_every_name_finds_its_files(data):
    man = Manifest(data)
    paths = [ROOT / p for p in data["paths"]]
    for c in data["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and any(f.is_relative_to(p) for p in paths)
        conf = json.loads(f.read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert set(conf["reduced"]) <= set(conf["assumed"])
    for w in data["workloads"]:
        cell = man.cell(w["name"])
        assert man.drive_file(cell.traffic["drive"]).is_file()
        assert man.reference_file(cell.traffic["reference"]).is_file()
        assert callable(man.drive(cell.traffic["drive"]).Drive)
        ref = man.reference(cell.traffic["reference"])
        assert all(callable(getattr(ref, f)) for f in (
            "expected", "numbers", "context"))
        assert set(cell.traffic["end_to_end"]) == {
            m["name"] for m in cell.end_to_end}
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
    for m in data["per_layer"]:
        mod = man.reader(m["name"])
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
            m["name"], m["unit"], m["layer"], m["source"], m["moves"])
        assert callable(mod.read)


def test_a_new_cell_is_only_new_files(tmp_path, data):
    """A configuration, a traffic mix with its own drive and reference, a
    cell and a per-layer metric added as new files and entries, no
    existing file edited, are found by name."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    extra = dict(data)
    conf = json.loads((root / "benchmark/configs/cornell_box_1080.json")
                      .read_text())
    conf["name"] = "cornell_box_720"
    conf["height"], conf["width"] = 720, 720
    (root / "benchmark/configs/cornell_box_720.json").write_text(
        json.dumps(conf))
    (root / "benchmark/drives/pan_frames.py").write_text(
        "class Drive:\n    pass\n")
    (root / "benchmark/reference/pan.py").write_text(
        "def expected(*a, **k):\n    return []\n"
        "def numbers(got, want):\n    return {}\n"
        "def context(*a, **k):\n    return {}\n")
    (root / "benchmark/traffic/restir_pan.json").write_text(json.dumps({
        "why": "x", "drive": "pan_frames", "reference": "pan",
        "features": {}, "check_units": 1, "warm_units": 1,
        "trace_units": 2,
        "end_to_end": {"frame_ms": "rate_ms", "setup_s": "setup_s"}}))
    (root / "benchmark/limits/cornell_box_720.pan.json").write_text(
        json.dumps({"mismatch": 0.001, "mean_gap": 0.001}))
    (root / "benchmark/metrics/gaps.frame.py").write_text(
        'NAME, UNIT, LAYER = "gaps.frame", "count", "device"\n'
        'SOURCE, MOVES = "device_trace", "frame_ms"\n'
        "def read(trace):\n    return len(trace.idle_gaps)\n")
    extra["configs"] = data["configs"] + [{
        "name": "cornell_box_720", "source": "https://example.org",
        "file": "benchmark/configs/cornell_box_720.json",
        "reduced": [], "why": "x"}]
    extra["workloads"] = data["workloads"] + [{
        "name": "cornell_box_720.pan", "config": "cornell_box_720",
        "traffic": "restir_pan", "chips": 1, "why": "x"}]
    extra["per_layer"] = data["per_layer"] + [{
        "name": "gaps.frame", "unit": "count", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "frame_ms",
        "workloads": ["cornell_box_720.pan"]}]
    man = Manifest(extra, root)
    cell = man.cell("cornell_box_720.pan")
    assert cell.config["height"] == 720
    assert [m["name"] for m in cell.end_to_end] == [
        "frame_ms", "frame_ms_p95", "setup_s"]
    assert "gaps.frame" in [m["name"] for m in cell.per_layer]
    assert man.drive_file(cell.traffic["drive"]).is_file()
    assert man.reference_file(cell.traffic["reference"]).is_file()
    assert man.reader("gaps.frame").read(type("T", (), {
        "idle_gaps": [1, 2]})()) == 2
    for p, b in before.items():
        assert p.read_bytes() == b, p


@pytest.mark.parametrize("name", ["../run", "a.b", "", "x y"])
def test_a_drive_name_is_a_module_name(name):
    with pytest.raises(ValueError):
        Manifest({}).drive(name)
