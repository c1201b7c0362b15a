"""Nothing the benchmark runs loads JAX or the JAX package; the references
load nothing of this repository.  Module names are compared by their whole
top-level name: the port's name, `fhe_icp_tpu_torch`, begins with the JAX
package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "fhe_icp_tpu", "benchmarks"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            for a in node.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    out.add(a.value.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_repository(path):
    mods = top_level_imports(path)
    assert not mods & (FORBIDDEN | {"fhe_icp_tpu_torch", "portbench"}), mods


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole traced run of every cell at a small size on the CPU, then the
    process's modules compared by top-level name."""
    code = f"""
import json, sys, torch
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(BENCH / 'tests')!r})
from small import run_small
for cell in ("search-100k", "compare-ring16384"):
    assert run_small(cell, trace=True)["correct"], cell
from portbench import harness
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    tops, bad = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert "fhe_icp_tpu_torch" in tops
    assert not set(tops) & FORBIDDEN and bad == []
