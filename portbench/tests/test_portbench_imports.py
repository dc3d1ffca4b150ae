"""No part of the benchmark loads JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import subprocess
import sys

from portbench import core

FORBIDDEN = {"jax", "jaxlib", "flax", "jckx"}


def imported(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(core.ROOT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((core.ROOT / "reference").rglob("*.py")):
        assert "jckx_torch" not in imported(path), path


def test_a_run_loads_no_jax_module():
    """Every module of the benchmark imported, and a tiny cell run on the
    CPU, in a fresh process: no module whose top-level name is forbidden."""
    code = """
import json, pathlib, sys, tempfile, time
sys.path[:0] = [{root!r}, {tests!r}]
import importlib
from portbench import core
for path in sorted(core.ROOT.rglob("*.py")):
    rel = path.relative_to(core.ROOT.parent).with_suffix("")
    if "tests" in rel.parts or path.stem == "conftest":
        continue
    core.load_module(path, "check_" + "_".join(rel.parts).replace(".", "_"))
from conftest import make_tiny_root, run_tiny
root = make_tiny_root(pathlib.Path(tempfile.mkdtemp()) / "r")
line, _ = run_tiny(root, "dcgan-64.train", seconds=0.2)
print(json.dumps([line["correct"], sorted(m for m in sys.modules if m.split(".")[0] in {bad!r})]))
""".format(root=str(core.ROOT.parent), tests=str(core.ROOT / "tests"), bad=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(core.ROOT.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"
