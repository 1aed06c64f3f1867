"""Nothing the benchmark runs loads JAX, Flax or the JAX package (judged by
the whole top-level module name: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

from portbench.harness import cells
from portbench.harness.context import FORBIDDEN, loaded_forbidden

SOURCES = sorted(p for p in cells.ROOT.rglob("*.py") if "tests" not in p.parts)


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(cells.ROOT)))
def test_no_source_imports_jax(path):
    assert not {m.split(".")[0] for m in _imported(path)} & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((cells.ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "neural_jacobian_field_torch" not in {m.split(".")[0] for m in _imported(path)}


def test_top_level_names_compare_whole(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "neural_jacobian_field_torch_probe.sub", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "neural_jacobian_field_tpu.ops", sys)
    assert loaded_forbidden() == ["neural_jacobian_field_tpu"]


_PROBE = """
import sys
sys.path.insert(0, {repo!r})
import importlib
from portbench.harness import cells
for kind in ("train_program", "control_loop"):
    cells.kind_module(kind)
for m in ("portbench.run", "portbench.calibrate", "portbench.harness.faults",
          "neural_jacobian_field_torch.training", "neural_jacobian_field_torch.inference.action_opt",
          "neural_jacobian_field_torch.models.model"):
    importlib.import_module(m)
import json
for name in json.load(open({bench!r}))["per_layer"]:
    cells.reader(name["name"])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_what_the_benchmark_loads_holds_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(
        repo=str(cells.REPO), bench=str(cells.REPO / "BENCHMARK.json"))],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
    assert "neural_jacobian_field_torch" in loaded


def test_reference_alone_loads_nothing_of_the_port():
    probe = (f"import sys; sys.path.insert(0, {str(cells.REPO)!r}); "
             "import portbench.reference.model, portbench.reference.steps; "
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "neural_jacobian_field_torch" not in eval(out.stdout.strip().splitlines()[-1])
