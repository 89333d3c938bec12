"""The port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (an AST walk over
every import statement; ``repro_torch`` itself is fine)."""
import ast
import pathlib

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "repro" or top == "jax" or top.startswith("jax")


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    bad = [f"{path.name}:{line}: import {mod}"
           for line, mod in _imported_modules(ast.parse(path.read_text()))
           if _forbidden(mod)]
    assert not bad, bad


def test_walk_covers_the_port_and_catches_violations():
    names = {p.name for p in FILES}
    assert {"dfl.py", "consensus.py", "ops.py", "train.py", "engine.py",
            "overlap.py", "schedule.py", "trace.py", "metrics.py",
            "monitor.py", "sharding.py", "mesh.py", "plans.py", "specs.py",
            "roofline.py", "dryrun.py", "chip_smoke.py"} <= names
    src = "import jax.numpy as jnp\nfrom repro.core import dfl\n" \
          "import repro_torch\nfrom jaxlib import x\n"
    found = [m for _, m in _imported_modules(ast.parse(src))
             if _forbidden(m)]
    assert found == ["jax.numpy", "repro.core", "jaxlib"]
