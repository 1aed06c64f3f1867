"""Cells, configurations, traffic kinds, limits and metric readers are found
by the names BENCHMARK.json gives; a new one is a file and an entry."""

import json
import shutil

import pytest

from portbench.harness import cells

BENCH = json.loads((cells.REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = cells.resolve(workload, BENCH)
    assert cell.config["model"]["action_dim"] == 8
    assert hasattr(cells.kind_module(cell.kind), "run")
    assert cell.limits, "every cell has its limits file"
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]).read)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_config_file_is_under_paths(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    assert json.loads((cells.REPO / entry["file"]).read_text())["source"] == entry["source"]


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))


def test_a_new_cell_traffic_kind_and_metric_are_files_only(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(cells.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    (root / "traffic" / "replay_burst.json").write_text(json.dumps({"kind": "replay", "n": 3}))
    (root / "kinds" / "replay.py").write_text("def run(ctx):\n    return 'replayed'\n")
    (root / "metrics" / "burst_ms.replay.py").write_text("def read(cell, out):\n    return 1.5\n")
    (root / "limits" / "allegro.burst.json").write_text(json.dumps({"answer_gap": 0.1}))
    bench["workloads"].append({"name": "allegro.burst", "config": "allegro",
                               "traffic": "replay_burst", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "burst_ms.replay", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "setup_s", "workloads": ["allegro.burst"]})
    cell = cells.resolve("allegro.burst", bench, root)
    assert cell.kind == "replay" and cell.limits == {"answer_gap": 0.1}
    assert cells.kind_module(cell.kind, root).run(None) == "replayed"
    assert [m["name"] for m in cell.per_layer] == ["burst_ms.replay"]
    assert cells.reader("burst_ms.replay", root).read(cell, None) == 1.5


def test_a_suffixed_metric_falls_back_to_its_family_reader(tmp_path):
    root = tmp_path / "portbench"
    (root / "metrics").mkdir(parents=True)
    (root / "metrics" / "gap_ms.py").write_text("def read(cell, out):\n    return 'family'\n")
    (root / "metrics" / "gap_ms.serve.py").write_text("def read(cell, out):\n    return 'own'\n")
    assert cells.reader("gap_ms.train", root).read(None, None) == "family"
    assert cells.reader("gap_ms.serve", root).read(None, None) == "own"
    with pytest.raises(FileNotFoundError):
        cells.reader("other_ms.train", root)


def test_unknown_workload_is_an_error():
    with pytest.raises(KeyError):
        cells.resolve("no.such.cell", BENCH)
