"""The port's seed panel (jckx_torch/panel.py) on the CPU: two seeds of the
tiny DCGAN trainer (16², width 8, batch 16, f32, synthetic data) with
``--device cpu`` and ``--extra_metrics 1``. The children run in this
process through ``run_child`` with a stub metrics engine (the seeded
InceptionV3 at 299² is too slow here; ``chip_smoke.py`` runs the real one
in subprocesses on the card).

- Each child is ``python -m jckx_torch train`` with the panel's seed, run
  dir and the forwarded flags, ``--device cpu`` among them.
- The verdict equals ``jckx.panel.collect`` / ``aggregate`` applied to the
  same run dirs, ``best_kid`` / ``best_precision`` included, and
  ``panel.json`` holds it.
- A rerun of the same panel resumes every seed (``--resume``); ``--sweep``
  runs the panel per variant; managed flags are refused.
"""

import json
import os

import pytest

from jckx import panel as jpanel
from jckx_torch import panel as tpanel
from jckx_torch.configs import get_arg_parse
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.train import main as tmain
from test_torch_trainer import StubMetrics


class ExtraStub(StubMetrics):
    """The trainer stub with KID and PRDC, its values moved by the seed."""

    def __init__(self, seed):
        super().__init__()
        self.offset = (seed % 7) / 10.0

    def fid(self, images_tanh=None, features=None):
        return super().fid() + self.offset

    def kid(self, features=None):
        return 0.5 / self.calls + self.offset, 0.01

    def prdc(self, features=None):
        return {"precision": 0.1 * self.calls + self.offset, "recall": 0.2, "density": 0.3,
                "coverage": 0.4 - self.offset}


FLAGS = ["--dataset", "synthetic", "--synthetic_size", "48", "-b", "16", "-e", "1",
         "--image_size", "16", "--base_width", "8", "--compute_dtype", "float32",
         "-mlr", "2e-4", "--log_every", "2", "--eval_every", "2", "--extra_metrics", "1",
         "--device", "cpu"]


@pytest.fixture
def children(monkeypatch, tmp_path):
    """Run each child's trainer in this process; → the argv of every child."""
    seen = []

    def run_child(argv):
        assert argv[1:4] == ["-m", "jckx_torch", "train"]
        seen.append(argv)
        cfg = get_arg_parse(argv[4:])
        cfg.data_dir = str(tmp_path / "data")
        MainLogger.reset()
        try:
            tmain.run(cfg, metrics=ExtraStub(cfg.seed))
        finally:
            MainLogger.reset()
        return 0

    monkeypatch.setattr(tpanel, "run_child", run_child)
    return seen


def test_panel_verdict_equals_jckx_collect_and_aggregate(tmp_path, children, capsys):
    root = str(tmp_path / "save")
    argv = ["--seeds", "0,1", "-m", "DCGAN", "--save_root", root, "--panel_name", "p"] + FLAGS
    assert tpanel.main(argv) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(children) == 2 and all(a[a.index("--device") + 1] == "cpu" for a in children)
    assert [a[a.index("--seed") + 1] for a in children] == ["0", "1"]
    runs = {s: os.path.join(root, "dcgan", "p", f"seed_{s}") for s in (0, 1)}
    want = {str(s): jpanel.collect(d) for s, d in runs.items()}
    got = verdict["per_seed"]
    for s in want:
        assert got[s].pop("exit_code") == 0
        assert got[s] == want[s]
        assert got[s]["evals"] == 2 and "best_kid" in got[s] and "best_precision" in got[s]
        assert "median_step_ms" in got[s]
    assert verdict["aggregate"] == jpanel.aggregate(want)
    assert verdict["ok"] and verdict["seeds"] == [0, 1] and not verdict["preempted"]
    assert set(verdict["aggregate"]["best_kid"]) == {"min", "median", "max", "rel_spread"}
    with open(os.path.join(root, "dcgan", "p", "panel.json")) as f:
        assert json.load(f)["aggregate"] == verdict["aggregate"]

    # the same panel again: every seed resumes and trains nothing
    children.clear()
    assert tpanel.main(argv) == 0
    assert all("--resume" in a for a in children) and len(children) == 2
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {s: {k: v for k, v in r.items() if k != "exit_code"}
            for s, r in again["per_seed"].items()} == want


def test_panel_sweep_and_refusals(tmp_path, children, capsys):
    root = str(tmp_path / "save")
    argv = ["--seeds", "3", "-m", "DCGAN", "--save_root", root, "--panel_name", "s",
            "--sweep", "lr_schedule=constant,cosine"] + FLAGS
    assert tpanel.main(argv) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(verdict["variants"]) == {"lr_schedule-constant", "lr_schedule-cosine"}
    for slug, row in verdict["variants"].items():
        run = os.path.join(root, "dcgan", "s", slug, "seed_3")
        assert row["per_seed"]["3"]["run_dir"] == run and os.path.isfile(
            os.path.join(run, "latest.ckpt"))
        assert row["aggregate"] == jpanel.aggregate(
            {k: {kk: vv for kk, vv in v.items() if kk != "exit_code"}
             for k, v in row["per_seed"].items()})
    for bad in (["--seed", "4"], ["-pm", "x"], ["--sweep", "seed=1,2"], ["--sweep", "lr=1"]):
        with pytest.raises(SystemExit):
            tpanel.get_args(["--seeds", "1", "-m", "DCGAN"] + bad)
    with pytest.raises(SystemExit, match="duplicate seed"):
        tpanel.get_args(["--seeds", "1,1", "-m", "DCGAN"])
    assert tpanel.BEST_OF == jpanel.BEST_OF
