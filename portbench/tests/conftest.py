"""Shared fixtures of the benchmark's CPU tests: a data root of tiny
configurations and cells (the real files, cut to a size the CPU runs in
seconds), removed after each test."""

import json
import math
import shutil
import tempfile
from pathlib import Path

import pytest
import torch

from portbench import core


def _merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s values, nested groups merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = _merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _tiny_config(cfg: dict, dtype: str, source: Path) -> dict:
    """The configuration with its own ``tiny`` overrides and, where it
    states a compute dtype, ``dtype``; its ``params`` counted anew by its
    family's reference."""
    cfg = _merged(cfg, cfg.pop("tiny", {}))
    if "compute_dtype" in cfg:
        cfg["compute_dtype"] = dtype
    shapes = core.reference(cfg, source).param_shapes(cfg)
    cfg["params"] = {net: sum(math.prod(s) for s in named.values())
                     for net, named in shapes.items()}
    return cfg


def make_tiny_root(root: Path, dtype: str = "bfloat16", source: Path = core.ROOT) -> Path:
    """Every configuration and cell of ``source`` cut by its own ``tiny``
    block, under ``root``. A family's own code (its reference, traffic
    kind, readers) outside the harness's folder is copied beside them."""
    for folder in ("configs", "workloads"):
        (root / folder).mkdir(parents=True)
    for path in (source / "configs").glob("*.json"):
        (root / "configs" / path.name).write_text(
            json.dumps(_tiny_config(core.load_json(path), dtype, source)))
    for path in (source / "workloads").glob("*.json"):
        wl = core.load_json(path)
        (root / "workloads" / path.name).write_text(json.dumps(_merged(wl, wl.pop("tiny", {}))))
    if source != core.ROOT:
        for folder in ("reference", "traffic", "layer_metrics"):
            for path in (source / folder).glob("*.py"):
                (root / folder).mkdir(exist_ok=True)
                shutil.copy(path, root / folder / path.name)
    return root


@pytest.fixture
def scratch():
    """A temporary directory, removed after the test."""
    path = Path(tempfile.mkdtemp(prefix="portbench-test-"))
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def tiny_root(scratch):
    return make_tiny_root(scratch / "root")


@pytest.fixture
def tiny_root_f32(scratch):
    return make_tiny_root(scratch / "root32", "float32")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads per test, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run_tiny(root: Path, cell: str, seed: int = 2 ** 31 + 17, seconds: float = 0.5,
             trace: bool = False):
    """The cell run on the CPU in ``root`` → (result line, standard error lines)."""
    import time

    spec = core.load_json(core.ROOT.parent / "BENCHMARK.json")
    return core.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(), spec, root)
