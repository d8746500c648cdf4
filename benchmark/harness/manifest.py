"""``BENCHMARK.json`` and the files it names.

A cell's files are found by name: its configuration's ``file``, the
traffic mix ``benchmark/traffic/<traffic>.json``, its limits
``benchmark/limits/<workload>.json`` and each per-layer metric's reader
``benchmark/metrics/<metric>.py``. A traffic mix names the program's
drive, ``benchmark/drives/<drive>.py`` (its ``Drive``), and the plain
reference that judges it, ``benchmark/reference/<reference>.py`` (its
``expected``, ``numbers`` and ``context``). Adding a cell, mix,
configuration, drive, reference or metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list


def _reports(entry: dict, cell: str, default: bool) -> bool:
    w = entry.get("workloads")
    return default if w is None else cell in w


class Manifest:
    def __init__(self, data: dict, root: Path = ROOT):
        self.data = data
        self.root = root

    @classmethod
    def load(cls, root: Path = ROOT) -> "Manifest":
        path = root / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing")
        return cls(json.loads(path.read_text()), root)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_file(self, name: str) -> Path:
        for c in self.data["configs"]:
            if c["name"] == name:
                return self.root / c["file"]
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic_file(self, name: str) -> Path:
        return self.root / "benchmark" / "traffic" / f"{name}.json"

    def limits_file(self, workload: str) -> Path:
        return self.root / "benchmark" / "limits" / f"{workload}.json"

    def metric_file(self, name: str) -> Path:
        return self.root / "benchmark" / "metrics" / f"{name}.py"

    def cell(self, name: str) -> Cell:
        w = self.workload(name)
        e2e = [m for m in self.data["end_to_end"]
               if _reports(m, name, True)]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in self.data["per_layer"]
                     if _reports(m, name, m["moves"] in reported)]
        return Cell(
            name=name, chips=int(w["chips"]),
            config=json.loads(self.config_file(w["config"]).read_text()),
            traffic=json.loads(self.traffic_file(w["traffic"]).read_text()),
            limits=json.loads(self.limits_file(name).read_text()),
            end_to_end=e2e, per_layer=per_layer)

    def reader(self, name: str):
        """The per-layer metric's module, loaded from its file."""
        path = self.metric_file(name)
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def drive_file(self, name: str) -> Path:
        return self.root / "benchmark" / "drives" / f"{name}.py"

    def reference_file(self, name: str) -> Path:
        return self.root / "benchmark" / "reference" / f"{name}.py"

    def drive(self, name: str):
        """The program's drive module ``drives/<name>.py``."""
        return _module("drives", name)

    def reference(self, name: str):
        """The plain reference module ``reference/<name>.py``."""
        return _module("reference", name)


def _module(package: str, name: str):
    if not MODULE.match(name):
        raise ValueError(f"{package}: {name!r} is not a module name")
    return importlib.import_module(f"{package}.{name}")
