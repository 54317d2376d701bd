"""Find a cell's parts by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic mix; the configuration's entry gives its file, the
traffic mix is ``traffic/<name>.json`` and each metric is read by
``metrics/<name>.py`` (a module with ``read(ctx) -> float | None``), all
under the benchmark's directory.  Nothing here knows a cell, a
configuration or a metric by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ["Cell", "resolve", "reader"]

BENCH_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    bench_dir: Path


def _reported_in(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell named ``workload`` with its configuration, traffic and
    metrics, from ``BENCHMARK.json`` beside ``bench_dir``."""
    root = bench_dir.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / confs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
        config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, workload)],
        bench_dir=bench_dir)


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
