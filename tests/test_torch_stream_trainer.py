"""The port's streaming data plane in the trainers (``--data_placement
stream``, ``auto`` with ``--hbm_data_budget``, ``-w``) on the CPU, at the
tiny setup of tests/test_step_torch_parity.py (16², width 8, batch 8,
f32), with a stub metrics engine.

- DCGAN and CGAN streamed through ``-w 2`` gather threads end with the
  parameters, EMA, Adam state and telemetry of the resident plane, bit for
  bit: both planes hand each step the same uint8 rows (jckx's own test
  allows 1e-5, tests/test_trainer.py:265-310; here equality is required).
- A streamed run cut by SIGTERM inside an epoch and resumed from its
  ``latest.ckpt`` ends as the uninterrupted run does: the first slab
  starts at the resume offset.
- The plane is chosen as jckx chooses it, and the log names it; an error
  in the uploader reaches ``train()``, and the uploader and gather
  threads are gone when ``train()`` returns or raises.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from jckx_torch.configs import check_ported, get_arg_parse
from jckx_torch.data.pipeline import HostStreamLoader
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.train import main as tmain
from torch_threads import one_torch_thread  # noqa: F401

_TIMING = ("images_per_sec", "step_ms")


@pytest.fixture(autouse=True)
def _fresh_logger():
    MainLogger.reset()
    yield
    MainLogger.reset()


class StubMetrics:
    """Deterministic stand-in for the InceptionV3 engine (FID / IS and
    CGAN's intra-FID); ``on_eval`` runs at every eval."""

    def __init__(self, on_eval=None):
        self.calls = 0
        self.on_eval = on_eval

    def extract_features(self, images):
        return np.random.RandomState(0).randn(len(images), 8).astype(np.float32)

    def inception_score(self, images=None, splits=10, logits=None):
        self.calls += 1
        if self.on_eval is not None:
            self.on_eval(self.calls)
        return 1.0 + 0.1 * self.calls

    def fid(self, images_tanh=None, intra_fid=False, label=0, features=None):
        return 100.0 / self.calls

    def intra_fid(self, images_tanh=None, features=None):
        return 50.0 / self.calls


def _argv(root, model, run, *extra):
    # 48 rows at batch 8: 6 steps an epoch; K = min(2, 3, 6) = 2, so three
    # launches (three slabs) an epoch, and evals after steps 2, 4, 6, 10, 12
    return ["-m", model, "--dataset", "synthetic" if model == "DCGAN" else "cifar10",
            "--synthetic_size", "48", "-b", "8", "-e", "2", "--image_size", "16",
            "--base_width", "8", "--compute_dtype", "float32", "-mlr", "2e-4",
            "--log_every", "2", "--eval_every", "3", "--ema_decay", "0.5",
            "--device", "cpu", "--save_root", str(root), "--data_dir", str(root / "data"),
            "-pm", run, *extra]


def _run(root, model, run, *extra, metrics=None):
    tr = tmain.run(get_arg_parse(_argv(root, model, run, *extra)),
                   metrics=metrics or StubMetrics())
    MainLogger.reset()
    return tr


def _state(tr):
    s = tr.state
    mods = {"G": s.G, "D": s.D, "EMA": s.ema_g}
    out = {f"{m}/{k}": v.clone() for m, mod in mods.items() for k, v in mod.state_dict().items()}
    for name, opt in (("opt_g", s.opt_g), ("opt_d", s.opt_d)):
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}/{i}/{k}": torch.as_tensor(v).clone() for k, v in st.items()})
    return out, s.step


def _telemetry(tr):
    with open(os.path.join(tr.save_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in _TIMING} for r in recs
            if r.get("event") != "session_start"]


def _assert_equal_states(a, b):
    (sa, step_a), (sb, step_b) = a, b
    assert step_a == step_b and sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _log(tr) -> str:
    return "".join(open(os.path.join(tr.save_path, f)).read()
                   for f in os.listdir(tr.save_path) if f.endswith(".log"))


def _no_worker_threads():
    deadline = time.time() + 10
    while time.time() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(("jckx-upload", "jckx-gather"))]
        if not alive:
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("model", ["DCGAN", "CGAN"])
def test_streamed_run_equals_resident(tmp_path, model):
    resident = _run(tmp_path, model, "resident", "--data_placement", "hbm")
    streamed = _run(tmp_path, model, "streamed", "--data_placement", "stream", "-w", "2")
    assert not resident._streaming and resident.images_dev is not None
    assert streamed._streaming and streamed.images_dev is None and streamed.labels_dev is None
    assert streamed.evals == resident.evals == [2, 4, 6, 10, 12]
    _assert_equal_states(_state(streamed), _state(resident))
    assert _telemetry(streamed) == _telemetry(resident)
    assert "data plane: host-streaming" in _log(streamed) and "2 gather workers" in _log(streamed)
    assert "data plane: resident on cpu" in _log(resident)
    assert _no_worker_threads()


def test_streamed_resume_inside_an_epoch_is_exact(tmp_path):
    stream = ("--data_placement", "stream", "-w", "2")
    straight = _run(tmp_path, "DCGAN", "straight", *stream)
    # SIGTERM during the first eval (step 2): latest.ckpt at the next launch
    # boundary, step 4, two steps before the end of epoch 0
    cut = _run(tmp_path, "DCGAN", "cut", *stream, metrics=StubMetrics(
        lambda calls: calls == 1 and os.kill(os.getpid(), signal.SIGTERM)))
    assert cut.preempted and cut.state.step == 4
    assert _no_worker_threads()
    resumed = _run(tmp_path, "DCGAN", "cut", "--resume", *stream)
    assert resumed.evals == [6, 10, 12]  # its first launch runs steps 4-6
    _assert_equal_states(_state(resumed), _state(straight))
    assert len(resumed._resumed_losses) == 12


@pytest.mark.parametrize("placement,budget,streams", [
    ("auto", 1, True), ("auto", 4 << 30, False), ("hbm", 1, False), ("stream", 4 << 30, True)])
def test_plane_choice_follows_jckx(tmp_path, placement, budget, streams):
    from jckx_torch.data.pipeline import DCGANDataPreprocessor
    from jckx_torch.models.dcgan import Discriminator, Generator
    from jckx_torch.train.gan_trainer import DCGANTrainer
    from jckx_torch.train.state import geometry

    cfg = get_arg_parse(_argv(tmp_path, "DCGAN", "r", "--data_placement", placement,
                              "--hbm_data_budget", str(budget)))
    check_ported(cfg)  # the two flags are ported: no refusal
    assert (cfg.data_placement, cfg.hbm_data_budget) == (placement, budget)
    cfg.save_path = str(tmp_path / "dcgan" / "r")
    geo = geometry(cfg)
    tr = DCGANTrainer(cfg, Generator(geo), Discriminator(geo), DCGANDataPreprocessor(cfg),
                      metrics=StubMetrics())
    assert tr._streaming is streams and (tr.images_dev is None) is streams
    gib = f"({48 * 32 * 32 * 3 / 2**30:.2f} GiB"
    assert (f"data plane: host-streaming {gib}, 1 gather workers, native gather)" if streams
            else f"data plane: resident on cpu {gib})") in _log(tr)


def test_uploader_error_reaches_train_and_threads_stop(tmp_path, monkeypatch):
    calls = []

    def failing_take(self, rows, out=None):
        calls.append(len(rows))
        if len(calls) == 2:
            raise OSError("disk read failed")
        return HostStreamLoader._assemble(self, np.ascontiguousarray(rows, np.int32), out)

    monkeypatch.setattr(HostStreamLoader, "take", failing_take)
    with pytest.raises(OSError, match="disk read failed"):
        _run(tmp_path, "DCGAN", "r", "--data_placement", "stream", "-w", "2")
    assert calls == [16, 16] and _no_worker_threads()
