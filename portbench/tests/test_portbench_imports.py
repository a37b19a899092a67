"""Nothing under portbench/ imports JAX or the JAX package (top-level module
names compared whole, so topsicle_tpu_torch is not topsicle_tpu), and the
reference imports nothing of the program under test."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "topsicle_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "topsicle_tpu_torch" not in top_level_imports(path)
    assert "topsicle_tpu_torch" not in path.read_text()


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom topsicle_tpu.kmers import x\n"
                   "import topsicle_tpu_torch\n")
    assert top_level_imports(bad) & FORBIDDEN == {"jax", "topsicle_tpu"}
