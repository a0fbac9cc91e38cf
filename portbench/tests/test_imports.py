"""What the benchmark imports: nothing of JAX or of the JAX package
anywhere under ``portbench/``, and nothing of the program under
``portbench/reference/``. Top-level module names are compared whole:
``sgc_tpu_torch`` begins with ``sgc_tpu`` and is not it."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import spec
from portbench.run import FORBIDDEN

SOURCES = sorted(spec.PACKAGE.rglob("*.py"))
REFERENCE = sorted((spec.PACKAGE / "reference").rglob("*.py"))


def top_level_imports(path) -> set[str]:
    """The top-level names of every module ``path`` imports (relative
    imports stay in the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def test_names_compared_whole():
    assert top_level_imports.__doc__
    assert "sgc_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "sgc_tpu" in FORBIDDEN and "jax" in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(spec.PACKAGE))
                              for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "sgc_tpu_torch" not in names
    assert names <= set(sys.stdlib_module_names) | {"numpy", "torch",
                                                     "portbench"}


def test_a_run_loads_no_jax():
    """A CPU run of a cell's set-up imports, in a fresh process, holds
    none of the forbidden top-level modules afterwards."""
    code = ("import sys; from portbench import spec, run; "
            "b = spec.Benchmark(); "
            "[spec.task(b.config(c['config'])['model']) "
            " for c in b.data['workloads']]; "
            "[spec.metric_reader(m['name']) "
            " for m in b.data['end_to_end'] + b.data['per_layer']]; "
            "import sgc_tpu_torch.graph.locality, "
            "sgc_tpu_torch.train.loops, sgc_tpu_torch.models.gat, "
            "sgc_tpu_torch.ops.autograd; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
