"""Guard: the port imports nothing of JAX or of the reference package.

Every module under src/repro_torch/, and chip_smoke.py, is parsed and
its import statements are checked, so a stray `import jax` or
`from repro...` fails here rather than on the machine with the card.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [
        name for name in _imported_roots(path)
        if name.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, f"{path}: imports {bad}"


def test_port_has_modules():
    assert len(FILES) > 20
