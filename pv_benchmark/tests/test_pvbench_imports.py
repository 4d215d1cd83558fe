"""Nothing under pv_benchmark imports JAX or the JAX package, and the plain
references import nothing of the program: by the whole top-level name of
every import, read from the source."""

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "predict_pv_yield_tpu"}
PROGRAM = "predict_pv_yield_tpu_torch"


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(PACKAGE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PACKAGE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert PROGRAM not in top_level_imports(path)


def test_whole_names_are_compared(tmp_path):
    source = tmp_path / "x.py"
    source.write_text("import predict_pv_yield_tpu_torch.models\nfrom jax.numpy import zeros\n")
    names = top_level_imports(source)
    assert PROGRAM in names and "predict_pv_yield_tpu" not in names and "jax" in names
