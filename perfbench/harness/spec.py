"""What one cell is: its entries in ``BENCHMARK.json`` and the files the
harness finds by their names.

    configs/<config>.json    the configuration's sizes and program settings
    traffic/<traffic>.json   the traffic mix's parameters
    metrics/<metric>.py      one reader a metric: ``read(run) -> float|None``
    limits/<workload>.json   the limit of each number the check compares

A later cell, metric or configuration is new files and new entries; no
file of the harness names one.  A per-layer entry lists the cells it is
read in under ``workloads``; an end-to-end entry without that key is read
in every cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

__all__ = ["Cell", "Metric", "load_cell", "BENCH_DIR", "ROOT"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable[[dict], Optional[float]]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    limits: dict            # the check's limits
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _reader(bench_dir: Path, name: str) -> Callable:
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(workload: str, bench_json: Optional[Path] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``bench_json`` (default: the repository's
    ``BENCHMARK.json``), its traffic, metrics and limits read from
    ``bench_dir``, its configuration file from the path the entry gives,
    relative to ``bench_json``."""
    bench_json = bench_json or ROOT / "BENCHMARK.json"
    bench = json.loads(bench_json.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    conf_file = bench_json.parent / confs[w["config"]]["file"]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", cells)]
    per = [m for m in bench["per_layer"] if workload in m["workloads"]]
    limits_path = bench_dir / "limits" / f"{workload}.json"

    def metrics(entries):
        return [Metric(m["name"], m["unit"], _reader(bench_dir, m["name"]))
                for m in entries]

    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads(conf_file.read_text()),
        traffic=json.loads(
            (bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads(limits_path.read_text()),
        end_to_end=metrics(e2e), per_layer=metrics(per))
