"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program: top-level module names
compared whole (the program's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "koemorph_tpu"}
PROGRAM = "koemorph_tpu_torch"


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_module_imports_jax(path):
    assert not imported_tops(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert PROGRAM not in tops and not tops & JAX_SIDE


def test_whole_name_compare():
    """The program's name is not the JAX package's, though it begins
    with it."""
    assert PROGRAM.split(".")[0] not in JAX_SIDE
    assert "koemorph_tpu.ops".split(".")[0] in JAX_SIDE


def test_reference_loads_alone():
    code = ("import sys; import perfbench.reference.stream, "
            "perfbench.reference.model, perfbench.harness.flops; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(JAX_SIDE | {PROGRAM})!r})); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
