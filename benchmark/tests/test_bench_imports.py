"""Nothing the benchmark runs imports JAX, Flax or the JAX package, and the
plain reference imports nothing of the program.  Module names are compared
by their top-level name, the part before the first dot, whole: the port's
name begins with the JAX package's and passes."""

import ast
import sys
import types
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "fhe_tpu"}
# what the reference side reads: no module of the program
REFERENCE_SIDE = ("reference.py", "workcounts.py", "trace.py")


def imported_top_names(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def run_files() -> list[Path]:
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", run_files(), ids=lambda p: p.name)
def test_no_file_the_benchmark_runs_imports_jax(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_reference_side_imports_nothing_of_the_program(name):
    names = imported_top_names(BENCH / name)
    assert "fhe_tpu_torch" not in names and not names & FORBIDDEN
    assert "fhe_tpu_torch" not in (BENCH / name).read_text()


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fhe_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert "fhe_tpu_torch_fake" not in harness.forbidden_modules()
    assert "jaxtyping" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fhe_tpu.scheme", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["fhe_tpu"]


def test_the_harness_loads_no_jax_in_a_fresh_process(tmp_path):
    import subprocess
    code = ("import sys; sys.path.insert(0, %r); from benchmark import harness, readings; "
            "import fhe_tpu_torch.api, fhe_tpu_torch.ops.ntt_cuda; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(BENCH.parent), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
