"""Discovery by name: a cell of BENCHMARK.json, its configuration file, its
traffic mix, the module of the mix's kind, its limits and the readers of
its per-layer metrics. Adding any of these is adding a file and an entry;
no table here lists them."""

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]  # the benchmark's folder
REPO = ROOT.parent


@dataclass
class Cell:
    name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: List[dict]  # BENCHMARK.json's metrics this cell reports
    per_layer: List[dict]
    limits: Dict[str, float] = field(default_factory=dict)  # limits/<workload>.json

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, benchmark: dict = None, root: Path = ROOT) -> Cell:
    """The cell named `workload` and everything it names, by file name."""
    bench = benchmark if benchmark is not None else load_json(root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    config = load_json(root / "configs" / f"{w['config']}.json")
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    limits_path = root / "limits" / f"{workload}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(workload, config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)], limits)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind_module(kind: str, root: Path = ROOT):
    """kinds/<kind>.py: runs a traffic mix of that kind."""
    return load_module(root / "kinds" / f"{kind}.py", f"portbench_kind_{kind}")


def reader(metric: str, root: Path = ROOT):
    """metrics/<name>.py, or else metrics/<family>.py for a name
    `<family>.<suffix>` whose suffix only says which end-to-end metric it
    moves: reads one per-layer metric (`read(cell, outcome)`)."""
    path = root / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = root / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path, "portbench_metric_" + path.stem.replace(".", "_"))
