"""A cell of BENCHMARK.json and the files it resolves to, found by name.

cell ``<config>.<traffic>``  -> the ``workloads`` entry of that name
config                       -> portbench/configs/<config>.json
the config's ``tool``        -> portbench/tools/<tool>.py (``-`` as ``_``)
traffic                      -> portbench/traffic/<traffic>.json
per-layer metric <name>      -> portbench/metrics/<name>.py, ``read(rec)``

Every end-to-end metric reports in every cell; a per-layer metric in the
cells its ``workloads`` lists.

A later cell, configuration, traffic mix or metric is a new file and a
new entry; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from ..gen.community import Traffic

HERE = Path(__file__).resolve().parents[1]         # portbench/
ROOT = HERE.parent                                  # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass
class Metric:
    name: str
    unit: str
    read: object        # read(rec) -> float | None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: Traffic
    end_to_end: list[dict]
    per_layer: list[Metric]

    @property
    def tool(self):
        """The module of the configuration's tool (see tools/)."""
        return importlib.import_module(
            "..tools." + self.config["tool"].replace("-", "_"), __package__)


def _reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load(name: str, bench_path=BENCHMARK) -> Cell:
    bench = json.loads(Path(bench_path).read_text())
    (w,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if w is None:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    config = json.loads((HERE / "configs" / f"{w['config']}.json")
                        .read_text())
    traffic = Traffic.load(HERE / "traffic" / f"{w['traffic']}.json")
    per_layer = [Metric(m["name"], m["unit"], _reader(m["name"]))
                 for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, w["chips"], config, traffic, bench["end_to_end"],
                per_layer)
