"""No module of leafbench imports JAX, jaxlib, Flax, optax or the JAX
package (top-level names compared whole: ``leaf_tpu_torch`` begins with
``leaf_tpu``), and the yardstick (the reference, the measurement code,
the comparison, the input generator and the metric readers) imports
nothing of the port."""

from __future__ import annotations

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "optax", "leaf_tpu"}
YARDSTICK = ("reference", "measure", "metrics", "check.py", "inputs.py",
             "cell.py")
SOURCES = sorted(os.path.relpath(os.path.join(d, f), HERE)
                 for d, _, files in os.walk(HERE) for f in files
                 if f.endswith(".py"))


def _top_names(path):
    tree = ast.parse(open(os.path.join(HERE, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_anywhere(path):
    assert not set(_top_names(path)) & BANNED, path


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.startswith(YARDSTICK)])
def test_the_yardstick_imports_nothing_of_the_port(path):
    assert "leaf_tpu_torch" not in set(_top_names(path)), path


def test_the_scan_sees_a_banned_name(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import leaf_tpu.ops\nfrom leaf_tpu_torch import x\n")
    tree = ast.parse(p.read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    assert names & BANNED == {"leaf_tpu"}
