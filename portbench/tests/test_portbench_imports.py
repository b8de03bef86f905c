"""What the benchmark imports, and a run without the program."""
from __future__ import annotations

import ast
import shutil
import subprocess
import sys

import pytest

from portbench.harness.spec import BENCH_DIR, ROOT

JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}   # "repro" is the JAX package
FILES = sorted(BENCH_DIR.rglob("*.py"))


def top_level_imports(path) -> set:
    """Top-level names of every module ``path`` imports, compared whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob(
    "*.py")) + sorted((BENCH_DIR / "roofline").glob("*.py")),
    ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.serve\nfrom repro_torch import x\n")
    assert top_level_imports(f) == {"repro_torch"}
    assert not top_level_imports(f) & JAX_NAMES
    f.write_text("from repro.models import x\n")
    assert top_level_imports(f) & JAX_NAMES == {"repro"}


def test_a_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dbrx-132b.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
