"""The command's refusals: without as many CUDA devices as the cell asks
for, and in a directory that holds only BENCHMARK.json and the
benchmark's folder, it exits non-zero and prints no result."""

import shutil
import subprocess
import sys

import pytest
import torch

from portbench import core

REPO = core.ROOT.parent
ARGS = ["--workload", "dcgan-64.train", "--seed", "2147483999", "--seconds", "1", "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=str(cwd),
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = run(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_only_the_benchmark_files_no_result(scratch):
    shutil.copy(REPO / "BENCHMARK.json", scratch / "BENCHMARK.json")
    shutil.copytree(core.ROOT, scratch / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(scratch)
    assert out.returncode != 0 and out.stdout == ""


def test_an_unknown_cell_is_refused():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nope", "--seed", "1",
                          "--seconds", "1"], cwd=str(REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == "" and "no workload" in out.stderr
