"""The port stands alone: ``jckx_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package (``import jckx`` pulls in JAX), nor flax or
msgpack (the port reads jckx's msgpack checkpoints with its own decoder),
so they run on a machine that has none of them."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _forbidden(name: str) -> bool:
    return name.startswith("jax") or any(name == top or name.startswith(top + ".")
                                         for top in ("jckx", "flax", "msgpack"))


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, jckx_torch\n"
        "for m in pkgutil.walk_packages(jckx_torch.__path__, 'jckx_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    for name in ("jckx_torch.serve", "jckx_torch.kernels.fused_bn_act", "jckx_torch.models.cgan",
                 "jckx_torch.evaluate", "jckx_torch.train.gan_trainer", "jckx_torch.rng",
                 "jckx_torch.export", "jckx_torch.convert", "jckx_torch.inspect",
                 "jckx_torch.doctor", "jckx_torch.panel", "jckx_torch.metrics.extra",
                 "jckx_torch.metrics.inception_train", "jckx_torch.ops.norm",
                 "jckx_torch.data.augment", "jckx_torch.checkpoint.msgpack",
                 "jckx_torch.checkpoint.jckx_ckpt", "jckx_torch.data.native_io",
                 "jckx_torch.data.pipeline", "jckx_torch.plan", "jckx_torch.utils.comm",
                 "jckx_torch.utils.cost"):
        assert name in out, name
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
