"""The port imports nothing of JAX: every module under
``linear_operator_tpu_torch/`` and ``chip_smoke.py``, parsed with ``ast``,
imports no ``jax``, ``jaxlib``, ``optax`` or ``linear_operator_tpu`` (its
own package, ``linear_operator_tpu_torch``, aside), at any depth: top level,
inside a function, or relative imports resolved to their package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "linear_operator_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "optax", "linear_operator_tpu"}
FILES = sorted((ROOT / PACKAGE).rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path):
    """The absolute names of the modules ``path`` imports, with their lines."""
    module = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    package = module if path.name == "__init__.py" else module.rpartition(".")[0]
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.rsplit(".", node.level - 1)[0] if node.level > 1 else package
                name = f"{base}.{node.module}" if node.module else base
            else:
                name = node.module
            yield name, node.lineno
            if node.module is None:
                yield from ((f"{name}.{alias.name}", node.lineno) for alias in node.names)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax(path):
    bad = [f"{path.name}:{line} imports {name}" for name, line in _imported(path) if _forbidden(name)]
    assert not bad, bad


def test_the_check_sees_what_it_must():
    """The parser reads relative imports into the port's own package, and
    names every forbidden form, nested in a function too."""
    own = dict(_imported(ROOT / PACKAGE / "models" / "gp.py"))
    assert f"{PACKAGE}.functions" in own and f"{PACKAGE}.operators.kernel" in own
    assert len(FILES) > 50
    for text in ("import jax", "import jax.numpy as jnp", "from jaxlib import xla_client", "import optax",
                 "from linear_operator_tpu.ops import rbf", "def f():\n    import linear_operator_tpu as lo"):
        names = [alias.name if isinstance(node, ast.Import) else node.module
                 for node in ast.walk(ast.parse(text)) if isinstance(node, (ast.Import, ast.ImportFrom))
                 for alias in node.names]
        assert any(_forbidden(n) for n in names), text
    assert not _forbidden(PACKAGE) and not _forbidden(f"{PACKAGE}.models")
