"""What the benchmark may import: nothing under ``bench/`` imports ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` (top-level names compared
whole: ``repro_torch`` is the program, not ``repro``), and the reference
imports nothing of the program either."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & JAX


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = imported_tops(path)
        assert "repro_torch" not in tops, path
        assert tops <= {"__future__", "dataclasses", "math", "torch",
                        "bench"}, (path, tops)
    # and of the benchmark, only the reference itself
    for path in (BENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("bench"):
                assert node.module.startswith("bench.reference"), path


def test_whole_names_are_compared():
    """``repro_torch`` and ``reprox`` are not ``repro``; ``repro.x`` is."""
    from bench.harness import FORBIDDEN

    def hit(name):
        return name.split(".")[0] in FORBIDDEN

    assert not hit("repro_torch.launch.steps") and not hit("reprox")
    assert hit("repro.core") and hit("jax") and hit("flax.linen")
