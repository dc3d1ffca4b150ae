"""The port's superstep (``jckx_torch/train/superstep.py``) on the CPU: the
train step captured once and replayed, with ``EagerGraph``, the stand-in
that re-runs the captured callable on the static inputs, in place of a
CUDA graph (the card's capture is held in tests/test_torch_gpu.py and
chip_smoke.py). The tiny setup of tests/test_step_torch_parity.py: 16²,
width 8, batch 8, f32, with a stub metrics engine.

- (a) The trainer through the superstep ends with the parameters, EMA,
  Adam state, step and telemetry of today's eager loop, bit for bit: DCGAN,
  CGAN, FusedProp, ``--remat both``, cosine, and both data planes.
- (b) Through it, the trainer's launches and evals at K = 4 are those of
  jckx's trainer (the comparison of tests/test_torch_trainer.py).
- (c) ``--resume``, a restore and the nan-guard's rollback invalidate the
  graph, the next step recaptures, and the run ends as an uninterrupted
  one.
- (d) The fine-tune at ``--scan_steps 0`` and ``4`` equals its eager loop.
- (e) The fused kernel's launch count grows by the step's count per
  replay, which a CUDA graph's replay does not run in Python.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

import jax

from jckx_torch.configs import get_arg_parse
from jckx_torch.kernels import fused_bn_act as fba
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.metrics import inception_train
from jckx_torch.train import gan_trainer
from jckx_torch.train import main as tmain
from jckx_torch.train.superstep import EagerGraph, Superstep, graph_for
from torch_threads import one_torch_thread  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

_TIMING = ("images_per_sec", "step_ms")


@pytest.fixture(autouse=True)
def _fresh_logger():
    MainLogger.reset()
    yield
    MainLogger.reset()


@pytest.fixture
def stand_in(monkeypatch):
    """Every trainer and fine-tune built while on runs its step through a
    superstep with the CPU's stand-in graph."""
    monkeypatch.setattr(gan_trainer, "graph_for", lambda *a, **k: (EagerGraph, ""))
    monkeypatch.setattr(inception_train, "graph_for", lambda *a, **k: (EagerGraph, ""))


class StubMetrics:
    """Deterministic stand-in for the InceptionV3 engine; ``on_eval`` runs
    at every eval."""

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
    # launches an epoch, and evals after steps 2, 4, 6, 10, 12
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
        out[f"{name}/lr"] = torch.tensor([g["lr"] for g in opt.param_groups])
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


def test_graph_route_follows_device_sanitize_and_mesh():
    assert graph_for(torch.device("cuda", 0))[0] is not None
    for args, why in (((torch.device("cpu"),), "CUDA graphs need the card"),
                      ((torch.device("cuda", 0), True), "--sanitize"),
                      ((torch.device("cuda", 0), False, object()), "mesh")):
        graph, reason = graph_for(*args)
        assert graph is None and why in reason


@pytest.mark.parametrize("model,extra", [
    ("DCGAN", ()),
    ("CGAN", ()),
    ("DCGAN", ("--fused_prop", "1")),
    ("DCGAN", ("--remat", "both")),
    ("DCGAN", ("--lr_schedule", "cosine", "-milr", "5e-5")),
    ("DCGAN", ("--data_placement", "stream", "-w", "2")),
    ("CGAN", ("--data_placement", "stream", "-w", "2")),
], ids=["dcgan", "cgan", "fused_prop", "remat_both", "cosine", "dcgan_stream", "cgan_stream"])
def test_superstep_equals_the_eager_loop(tmp_path, monkeypatch, model, extra):
    eager = _run(tmp_path, model, "eager", *extra)
    assert eager.superstep is None
    monkeypatch.setattr(gan_trainer, "graph_for", lambda *a, **k: (EagerGraph, ""))
    graphed = _run(tmp_path, model, "graphed", *extra)
    ss = graphed.superstep
    # one eager step, one capture, and every later step replayed
    assert (ss.captures, ss.replays) == (1, 11) and ss.launches == 0
    _assert_equal_states(_state(graphed), _state(eager))
    assert _telemetry(graphed) == _telemetry(eager)
    assert graphed.evals == eager.evals == [2, 4, 6, 10, 12]


def test_trainer_through_the_superstep_matches_jckx_at_k4(tmp_path, stand_in):
    from jckx.configs import Config as JConfig
    from jckx.data.pipeline import DCGANDataPreprocessor as JPre
    from jckx.logging.main_logger import MainLogger as JLogger
    from jckx.models import dcgan as jdcgan
    from jckx.train.gan_trainer import DCGANTrainer as JTrainer

    from jckx_torch.configs import Config
    from jckx_torch.data.pipeline import DCGANDataPreprocessor
    from jckx_torch.models.dcgan import Discriminator, Generator
    from jckx_torch.train.state import geometry

    # 8 steps an epoch, 2 epochs, K = min(4, 5, 8) = 4: launches end at 4, 8, 12, 16
    tiny = dict(dataset="synthetic", batch_size=16, epoch=2, image_size=16, base_width=8,
                num_classes=10, compute_dtype="float32", max_learning_rate=2e-4,
                log_every=4, eval_every=5, log_file=1)
    jc = JConfig()
    for k, v in {**tiny, "save_root": str(tmp_path), "data_dir": str(tmp_path / "data"),
                 "save_path": str(tmp_path / "jckx")}.items():
        setattr(jc, k, v)
    jdata = JPre(jc)
    jdata.images_u8, jdata.labels_np = jdata.images_u8[:128], jdata.labels_np[:128]
    geo = jdcgan.GANGeometry(z_dim=100, image_size=16, channels=3, base_width=8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    JTrainer(jc, jdcgan.generator_init(k1, geo), jdcgan.discriminator_init(k2, geo), jdata,
             metrics=StubMetrics()).train()
    JLogger.reset()

    cfg = Config()
    for k, v in {**tiny, "device": "cpu", "save_root": str(tmp_path),
                 "data_dir": str(tmp_path / "data"),
                 "save_path": str(tmp_path / "dcgan" / "port")}.items():
        setattr(cfg, k, v)
    data = DCGANDataPreprocessor(cfg)
    data.images_u8, data.labels_np = data.images_u8[:128], data.labels_np[:128]
    gen = torch.Generator().manual_seed(1)
    tr = gan_trainer.DCGANTrainer(cfg, Generator(geometry(cfg), gen=gen),
                                  Discriminator(geometry(cfg), gen=gen), data,
                                  metrics=StubMetrics())
    tr.train()
    assert (tr.superstep.captures, tr.superstep.replays) == (1, 15)

    def records(path):
        with open(os.path.join(path, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    ref, got = records(jc.save_path), records(tr.save_path)
    evals = lambda recs: [r["step"] for r in recs if "fid" in r]  # noqa: E731
    launches = lambda recs: [r["step"] for r in recs if "step_ms" in r]  # noqa: E731
    assert evals(got) == evals(ref) == tr.evals == [4, 8, 12, 16]
    assert launches(got) == launches(ref) == [4, 8, 12, 16]
    assert set(got[1]) == set(ref[1])
    assert all(np.isfinite(r[k]) for r in got if "step_ms" in r for k in ("loss_d", "loss_g"))


@pytest.mark.parametrize("how", ["resume", "restore", "rollback"])
def test_restores_invalidate_and_recapture(tmp_path, monkeypatch, stand_in, how):
    straight = _run(tmp_path, "DCGAN", "straight")
    want = _state(straight)
    if how == "resume":
        # SIGTERM during the first eval (step 2): latest.ckpt at step 4
        cut = _run(tmp_path, "DCGAN", "cut", metrics=StubMetrics(
            lambda calls: calls == 1 and os.kill(os.getpid(), signal.SIGTERM)))
        assert cut.preempted and cut.state.step == 4 and cut.superstep.captures == 1
        resumed = _run(tmp_path, "DCGAN", "cut", "--resume")
        # restored in __init__, then steps 4 (eager), 5-11 (replayed)
        assert (resumed.superstep.captures, resumed.superstep.replays) == (1, 7)
        _assert_equal_states(_state(resumed), want)
        return
    if how == "restore":
        tr = _run(tmp_path, "DCGAN", "again")
        assert tr.superstep.captured
        tr._restore(os.path.join(tr.save_path, "latest.ckpt"))
        assert not tr.superstep.captured and tr.state.step == 12
        _assert_equal_states(_state(tr), want)
        return
    # the nan-guard: non-finite telemetry at step 4 (the third launch)
    # rolls back to latest.ckpt (step 4), which invalidates the graph; the
    # next train() recaptures and ends as the uninterrupted run
    trainers, calls = [], []
    init, body = gan_trainer._BaseGANTrainer.__init__, gan_trainer._BaseGANTrainer._graph_body

    def keep(self, *a, **k):
        init(self, *a, **k)
        trainers.append(self)

    def poisoned(self, x):
        calls.append(1)
        out = body(self, x)
        return out * float("nan") if len(calls) == 4 else out  # replays of steps 1, 2, 3, 4

    monkeypatch.setattr(gan_trainer._BaseGANTrainer, "__init__", keep)
    monkeypatch.setattr(gan_trainer._BaseGANTrainer, "_graph_body", poisoned)
    with pytest.raises(FloatingPointError, match="non-finite"):
        _run(tmp_path, "DCGAN", "nan")
    (tr,) = trainers
    assert tr.state.step == 4 and not tr.superstep.captured and tr.superstep.captures == 1
    tr.train()
    # steps 1-5 replayed before the abort; 4 eager again, then 5-11 replayed
    assert (tr.superstep.captures, tr.superstep.replays) == (2, 5 + 7)
    _assert_equal_states(_state(tr), want)


def _ft_args(tmp_path, save, *extra):
    return inception_train.get_args([
        "--device", "cpu", "--compute_dtype", "float32", "--image_size", "75", "-mlr", "0.01",
        "--dataset", "synthetic", "--synthetic_size", "40", "-b", "8", "-e", "1",
        "--max_steps_per_epoch", "5", "--eval_samples", "8", "--save_dir", str(save),
        "--save_path", str(tmp_path), "--data_dir", str(tmp_path / "data"), *extra])


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("scan", ["0", "4"])
def test_finetune_superstep_equals_the_eager_loop(tmp_path, monkeypatch, scan):
    eager = inception_train.train(_ft_args(tmp_path, tmp_path / "eager", "--scan_steps", scan))
    MainLogger.reset()
    assert eager.superstep is None
    monkeypatch.setattr(inception_train, "graph_for", lambda *a, **k: (EagerGraph, ""))
    graphed = inception_train.train(_ft_args(tmp_path, tmp_path / "graphed", "--scan_steps", scan))
    assert (graphed.superstep.captures, graphed.superstep.replays) == (1, 4)
    for f in ("last_bset.npz", "train_state.npz"):
        a, b = _npz(tmp_path / "eager" / f), _npz(tmp_path / "graphed" / f)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f}: {k}")
    for ea, eb in zip(eager.epochs, graphed.epochs):
        for k in ("steps", "train_loss", "train_acc", "top1", "loss"):
            assert ea[k] == eb[k], k


def test_launches_are_added_per_replay(tmp_path, monkeypatch):
    """A toy body that counts 3 launches: a warm step counts its own, a
    capture takes back what its Python counted, each replay adds 3. Then
    the fine-tune's real body on the CPU, its kernel wrapper counting as
    on the card: 94 per step, eager or replayed."""
    def body(x):
        fba.add_launches(3)
        return x["v"] * 2

    ss = Superstep(body, torch.device("cpu"), EagerGraph)
    fba.LAUNCHES = 0
    out = ss.replay(5, lambda j: {"v": torch.tensor([float(j)])})
    assert fba.LAUNCHES == 15 and ss.launches == 3 and (ss.captures, ss.replays) == (1, 4)
    assert out.tolist() == [[0.0], [2.0], [4.0], [6.0], [8.0]]

    from jckx_torch.ops import norm

    plain = norm.normalize_act_op

    def counting(*args):
        fba.add_launches(1)
        return plain(*args)

    monkeypatch.setattr(norm, "normalize_act_op", counting)
    for name, graph in (("eager", None), ("graphed", EagerGraph)):
        monkeypatch.setattr(inception_train, "graph_for",
                            lambda *a, g=graph, **k: (g, "") if g else (None, "test"))
        fba.LAUNCHES = 0
        run = inception_train.train(_ft_args(tmp_path, tmp_path / name, "--scan_steps", "3",
                                             "--max_steps_per_epoch", "3"))
        MainLogger.reset()
        assert fba.LAUNCHES == 94 * 3, name
        if graph is not None:
            assert run.superstep.launches == 94 and run.superstep.replays == 2
