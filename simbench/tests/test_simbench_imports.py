"""Nothing the benchmark runs imports JAX or the JAX package `repro`, and
the reference imports nothing of the program (`repro_torch`).  Module
names are compared by their top-level name as a whole word, since
`repro_torch` starts with `repro`."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

SIMBENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(SIMBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(SIMBENCH)))
def test_no_jax_and_no_program_in_the_reference(path):
    found = top_level_imports(path)
    assert not found & JAX
    if "reference" in path.relative_to(SIMBENCH).parts:
        assert "repro_torch" not in found
        assert found <= {"__future__", "dataclasses", "inspect", "math",
                         "typing", "numpy", "torch"}


def test_importing_the_reference_loads_neither():
    code = ("import sys; import simbench.reference, simbench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=SIMBENCH.parent,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
