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
from portbench.reference import cost

def _tiny_config(cfg: dict, dtype: str) -> dict:
    cfg = {**cfg, "image_size": 16, "base_width": 8, "z_dim": 8, "num_classes": 10,
           "compute_dtype": dtype}
    cfg["train"] = {**cfg["train"], "batch_size": 16, "log_every": 4}
    cfg["serve"] = {**cfg["serve"], "batch_size": 16}
    shapes = cost.param_shapes(cfg)
    cfg["params_g"] = sum(math.prod(s) for s in shapes["g"].values())
    cfg["params_d"] = sum(math.prod(s) for s in shapes["d"].values())
    return cfg


def _tiny_workload(wl: dict) -> dict:
    wl = dict(wl, trace_seconds=1)
    if "data" in wl:
        wl["data"] = {"rows": 256, "size": 8, "channels": 3, "classes": 10}
    if "request_images" in wl:
        wl["request_images"] = 64
    return wl


def make_tiny_root(root: Path, dtype: str = "bfloat16") -> Path:
    (root / "configs").mkdir(parents=True)
    (root / "workloads").mkdir()
    for path in (core.ROOT / "configs").glob("*.json"):
        (root / "configs" / path.name).write_text(
            json.dumps(_tiny_config(core.load_json(path), dtype)))
    for path in (core.ROOT / "workloads").glob("*.json"):
        (root / "workloads" / path.name).write_text(
            json.dumps(_tiny_workload(core.load_json(path))))
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
