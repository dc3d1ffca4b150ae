"""The port stands alone: ``jckx_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package (``import jckx`` pulls in JAX), so they
run on a machine that has neither."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _forbidden(name: str) -> bool:
    return name.startswith("jax") or name == "jckx" or name.startswith("jckx.")


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, jckx_torch\n"
        "for m in pkgutil.walk_packages(jckx_torch.__path__, 'jckx_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert "jckx_torch.serve" in out and "jckx_torch.kernels.fused_bn_act" in out
    assert [m for m in out if _forbidden(m)] == []


def test_no_source_of_the_port_imports_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "jckx_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert len(files) > 10 and bad == []
