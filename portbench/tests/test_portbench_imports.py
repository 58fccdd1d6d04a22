"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (read from the sources: the
test process itself may hold JAX)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if p.parent.name != "tests"
                 or p.name.startswith(("test_", "_")))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & BANNED


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        names = imported(path)
        assert "repro_torch" not in names, path
        assert names <= {"__future__", "math", "numpy", "torch",
                         "portbench"}, (path, names)
        if "portbench" in names:      # only the reference's own modules
            text = path.read_text()
            assert "portbench.lib" not in text and "deployments" not in text


def test_the_guard_compares_whole_names():
    tree = ast.parse("import repro_torch\nfrom repro_torch import x\n"
                     "import jax.numpy\nfrom repro.core import y\n")
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names & BANNED == {"jax", "repro"}


def test_the_run_time_guard_compares_whole_names():
    import _tiny  # noqa: F401
    from portbench.lib.cell import banned_modules
    assert banned_modules(["repro_torch", "repro_torch.core", "numpy"]) == []
    assert banned_modules(["repro.core.query", "jax.numpy", "flax",
                           "jaxlib", "jaxtyping"]) == ["flax", "jax",
                                                       "jaxlib", "repro"]
