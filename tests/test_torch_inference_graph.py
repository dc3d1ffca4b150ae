"""The port's inference programs as graphs (``jckx_torch/utils/graphs.py``'s
``GraphedProgram``) on the CPU, with ``EagerGraph``, the stand-in that
re-runs the captured callable on the static inputs and keeps one static
output, in place of a CUDA graph (the card's capture is held in
tests/test_torch_gpu.py and chip_smoke.py). Each route is compared with
the same object's eager route (its program set to None), bit for bit; the
tiny setup of tests/test_step_torch_parity.py: 16², width 8, batch 8, f32.

- ``GraphedProgram``: one capture per key (shapes and dtypes), replays
  after it, each answer a copy; ``invalidate`` recaptures; the fused
  kernel's launches are added per replay; ``graph_for``'s routes.
- ``GeneratorService.sample`` over 3.5 batches (the window holds all four,
  so a replay that aliased an earlier answer would show): float,
  sub-pixel, int8, truncated, CGAN with and without labels; one render on
  injected z against jckx's ``GeneratorService`` on the same weights.
- ``ArtifactService`` and ``load_exported``.
- The trainer's eval renders, and a restore that binds a new EMA builds a
  new program: the old one, the stand-in shows, renders the old weights.
- ``evaluate``'s result dict, with CGAN's chunks (a shorter last chunk has
  its own key), int8 and truncation; ``extract_features`` on a device set
  and a host set's slabs (InceptionV3 at 75², the resize to 299 cut).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jckx import serve as jserve
from jckx.checkpoint.torch_convert import export_torch_gan_checkpoint
from jckx.models import dcgan as jdcgan
from jckx.train.state import make_template_state
from jckx_torch import evaluate as tevaluate
from jckx_torch import export as texport
from jckx_torch import serve as tserve
from jckx_torch.checkpoint.checkpoint import state_payload
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.configs import Config
from jckx_torch.data import pipeline
from jckx_torch.kernels import fused_bn_act as fba
from jckx_torch.metrics import inception_v3 as tiv
from jckx_torch.metrics import metrics as tmetrics
from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
from jckx_torch.train import gan_trainer, superstep
from jckx_torch.utils.graphs import CudaGraph, EagerGraph, GraphedProgram, graph_for
from torch_threads import one_torch_thread  # noqa: F401

GEO = jdcgan.GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)
BS = 8
K = 10


def _as_on_the_card(device, sanitize=False, mesh=None):
    """``graph_for``'s rules as on a card, with the stand-in graph."""
    cls, why = graph_for(torch.device("cuda"), sanitize, mesh)
    return (EagerGraph if cls is not None else None), why


@pytest.fixture
def stand_in(monkeypatch):
    """Every program built while on is a ``GraphedProgram`` over the CPU's
    stand-in graph, where the card would build one."""
    for mod in (tserve, texport, gan_trainer, tevaluate, tmetrics):
        monkeypatch.setattr(mod, "graph_for", _as_on_the_card)


def _ckpt(tmp_path, conditional=False):
    state = make_template_state(GEO, conditional=conditional, num_classes=K)
    path = str(tmp_path / ("cgan.pt" if conditional else "dcgan.pt"))
    export_torch_gan_checkpoint(state, conditional=conditional, geo=GEO, num_classes=K, path=path)
    return state, path


def _eager(obj, attr, fn):
    """``fn()`` through ``obj``'s eager route (its program set to None)."""
    program = getattr(obj, attr)
    setattr(obj, attr, None)
    try:
        return fn()
    finally:
        setattr(obj, attr, program)


# ------------------------------------------------------------ the program

def test_graphed_program_captures_per_key_and_replays(monkeypatch):
    """A toy program that counts 2 launches: the first call at a key is the
    warm call (its own 2), the capture counts none, every replay adds 2; a
    new shape or a None input is another key; each answer is a copy, the
    static output is overwritten by every replay; ``invalidate`` drops the
    graphs and the next call captures again."""
    monkeypatch.setattr(fba, "LAUNCHES", 0)
    runs = []

    def fn(x, y):
        fba.add_launches(2)
        runs.append(tuple(x.shape))
        return x * 2 if y is None else x * 2 + y

    p = GraphedProgram(fn, "cpu", EagerGraph)
    a = p(torch.arange(3.0), None)
    assert (p.captures, p.replays, fba.LAUNCHES, len(runs)) == (1, 0, 2, 1)
    b = p(torch.arange(3.0) + 10, None)
    c = p(torch.arange(3.0) + 20, None)
    assert (p.captures, p.replays, fba.LAUNCHES) == (1, 2, 6)
    assert a.tolist() == [0, 2, 4] and b.tolist() == [20, 22, 24] and c.tolist() == [40, 42, 44]
    (static,) = [cap.output for _, cap in p._captures.values()]
    assert torch.equal(static, c) and static is not c  # one static output, copied out
    p(torch.arange(5.0), None)
    p(torch.arange(3.0), torch.ones(3))
    p(torch.arange(3.0).double(), None)
    assert p.captures == 4 and len(p.keys) == 4 and p.replays == 2
    assert p(torch.arange(3.0), torch.ones(3)).tolist() == [1, 3, 5] and p.replays == 3
    p.invalidate()
    assert p.keys == [] and p.pool_bytes == 0
    assert p(torch.arange(3.0), None).tolist() == [0, 2, 4] and p.captures == 5
    assert fba.LAUNCHES == 2 * 8  # eight calls, each counted once


def test_graphed_program_counts_both_kernels_per_replay(monkeypatch):
    """A program that launches the normalize kernel once and the moments
    kernels twice: each replay adds its warm call's counts to ``LAUNCHES``
    and ``MOMENTS_LAUNCHES`` apart; the capture adds none."""
    monkeypatch.setattr(fba, "LAUNCHES", 0)
    monkeypatch.setattr(fba, "MOMENTS_LAUNCHES", 0)

    def fn(x):
        fba.add_launches(1, 2)
        return x + 1

    p = GraphedProgram(fn, "cpu", EagerGraph)
    p(torch.zeros(3))
    assert (fba.LAUNCHES, fba.MOMENTS_LAUNCHES) == (1, 2)
    for _ in range(3):
        p(torch.ones(3))
    assert (p.captures, p.replays, fba.LAUNCHES, fba.MOMENTS_LAUNCHES) == (1, 3, 4, 8)


def test_graph_for_routes_and_the_superstep_shares_them():
    cuda = torch.device("cuda", 0)
    assert graph_for(cuda) == (CudaGraph, "")
    for why, args in (("on cpu", (torch.device("cpu"),)), ("--sanitize", (cuda, True)),
                      ("on a mesh", (cuda, False, object()))):
        cls, reason = graph_for(*args)
        assert cls is None and why in reason
    assert (superstep.CudaGraph, superstep.EagerGraph, superstep.graph_for) == (
        CudaGraph, EagerGraph, graph_for)
    assert gan_trainer.graph_for is graph_for


# ---------------------------------------------------------------- serving

MODES = {"float": (False, {}), "subpixel": (False, {"subpixel": True}),
         "int8": (False, {"quant": "int8"}), "truncated": (False, {"truncation": 0.7}),
         "cgan_labels": (True, {}), "cgan_random": (True, {})}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_service_sample_equals_the_eager_route(tmp_path, stand_in, mode):
    conditional, kw = MODES[mode]
    _, path = _ckpt(tmp_path, conditional)
    svc = tserve.GeneratorService(path, batch_size=BS, compute_dtype=torch.float32,
                                  device="cpu", **kw)
    labels = [3, 1, 4, 1, 5] if mode == "cgan_labels" else None
    n = 3 * BS + BS // 2  # 3.5 batches: four renders in one window, the last trimmed
    got = svc.sample(n, labels=labels, seed=11)
    prog = svc.program
    assert (prog.captures, prog.replays) == (1, 3)
    want = _eager(svc, "program", lambda: svc.sample(n, labels=labels, seed=11))
    assert got.shape == (n, 16, 16, 3) and np.array_equal(got, want)
    batches = [got[i:i + BS].tobytes() for i in range(0, 3 * BS, BS)]
    assert len(set(batches)) == 3  # distinct batches: an aliased window would repeat one
    # without a seed the request counter moves on the same way on both routes
    a = svc.sample(BS)
    svc._count -= 1
    assert np.array_equal(a, _eager(svc, "program", lambda: svc.sample(BS)))


def test_replayed_render_matches_jckx_on_the_same_z(tmp_path, stand_in):
    """One render on injected z, through the replay, against jckx's service
    on the same weights (``params_from_jax`` of its generator equals the
    port's): within 1 LSB, >= 99 % exact (tests/test_torch_serve.py)."""
    _, path = _ckpt(tmp_path)
    svc = tserve.GeneratorService(path, batch_size=BS, compute_dtype=torch.float32, device="cpu")
    jsvc = jserve.GeneratorService(path, batch_size=BS, compute_dtype=jnp.float32)
    for k, v in params_from_jax(jsvc.params_g, GEO, "g").items():
        assert torch.equal(v, svc.G.state_dict()[k]), k
    rng = np.random.RandomState(0)
    svc.render(torch.from_numpy(rng.randn(BS, GEO.z_dim).astype(np.float32)))  # the capture
    z = rng.randn(BS, GEO.z_dim).astype(np.float32)
    got = svc.render(torch.from_numpy(z)).numpy()
    assert svc.program.replays == 1
    ref = np.asarray(jserve.tanh_to_u8(jsvc.sampler_apply(jsvc.params_g, jnp.asarray(z), None)))
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert got.shape == ref.shape and diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_interpolation_and_a_local_mesh_stay_eager(tmp_path, stand_in):
    _, path = _ckpt(tmp_path)
    svc = tserve.GeneratorService(path, batch_size=BS, compute_dtype=torch.float32, device="cpu")
    walk = svc.interpolate(1, 2, steps=BS)
    assert svc.program.captures == 0
    assert np.array_equal(walk, _eager(svc, "program", lambda: svc.interpolate(1, 2, steps=BS)))
    mesh = tserve.serving_mesh("2", "cpu")
    assert tserve.GeneratorService(path, batch_size=BS, device="cpu", mesh=mesh).program is None


@pytest.mark.parametrize("conditional", [False, True])
def test_artifact_replays_equal_the_eager_call(tmp_path, monkeypatch, stand_in, conditional):
    _, path = _ckpt(tmp_path, conditional)
    dst = str(tmp_path / "g.pt2")
    texport.export_generator(path, dst, batch_size=BS, compute_dtype=torch.float32, device="cpu")
    art = texport.ArtifactService(dst, device="cpu")
    for labels in ([2, 7, 1], None) if conditional else (None,):
        got = art.sample(3 * BS + 3, labels=labels, seed=5)
        want = _eager(art, "program", lambda: art.sample(3 * BS + 3, labels=labels, seed=5))
        assert np.array_equal(got, want)
    assert art.program.captures == 1 and art.program.replays == (7 if conditional else 3)
    sample = texport.load_exported(dst, device="cpu")
    monkeypatch.setattr(texport, "graph_for", graph_for)
    eager = texport.load_exported(dst, device="cpu")
    lab = np.arange(BS) % K if conditional else None
    first, again = sample(9, lab), sample(9, lab)  # the capture, then a replay
    assert torch.equal(again, eager(9, lab)) and torch.equal(first, again) and first is not again


# ----------------------------------------------------- trainer, evaluate

class _Data:
    images_u8 = np.random.RandomState(0).randint(0, 256, (16, 16, 16, 3), np.uint8)
    labels_np = np.zeros(16, np.int32)
    num_classes = K
    metric_source = (images_u8, labels_np)


def _trainer(tmp_path):
    cfg = Config()
    for k, v in dict(dataset="synthetic", batch_size=BS, epoch=1, image_size=16, base_width=8,
                     z_dim=16, compute_dtype="float32", max_learning_rate=2e-4, log_every=2,
                     eval_every=0, ema_decay=0.5, sample_count=BS, log_file=0, device="cpu",
                     save_root=str(tmp_path), data_dir=str(tmp_path / "data"),
                     save_path=str(tmp_path / "run")).items():
        setattr(cfg, k, v)
    geo = GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)
    gen = torch.Generator().manual_seed(0)
    return gan_trainer.DCGANTrainer(cfg, Generator(geo, gen=gen), Discriminator(geo, gen=gen),
                                    _Data())


def test_eval_renders_replay_and_a_restore_builds_a_new_program(tmp_path, stand_in):
    tr = _trainer(tmp_path)
    tr.train()  # 2 steps
    a, b = tr.sample_eval(), tr.sample_eval()  # the capture, a replay
    prog = tr.eval_program
    assert (prog.captures, prog.replays) == (1, 1) and torch.equal(a, b)
    assert torch.equal(b, _eager(tr, "eval_program", tr.sample_eval))
    path = tr.ckpt.save_latest(state_payload(tr.state))
    tr.cfg.epoch = 2
    tr.train()  # 2 more steps move G and the EMA
    moved = tr.sample_eval()  # Adam and the EMA moved the tensors the program reads in place
    assert not torch.equal(moved, a) and tr.eval_program is prog
    assert torch.equal(moved, _eager(tr, "eval_program", tr.sample_eval))
    tr._restore(path)  # binds a new EMA module
    assert tr.eval_program is not prog and tr.eval_program.captures == 0
    restored = tr.sample_eval()
    assert torch.equal(restored, a)
    assert torch.equal(restored, _eager(tr, "eval_program", tr.sample_eval))
    # without the new program the stand-in, as the card, renders the old module's weights
    stale = gan_trainer.sample_eval_images(None, tr.eval_z, None, tr.cd, None, prog)
    assert torch.equal(stale, moved) and not torch.equal(stale, restored)


@pytest.fixture
def small_inception(monkeypatch):
    """InceptionV3 at 75² (its minimum): the engine's resize to 299 cut."""
    real = pipeline.resize_bilinear
    monkeypatch.setattr(tmetrics, "resize_bilinear", lambda x, size: real(x, 75))
    return tiv.init(0, num_classes=K)


def _metrics(tmp_path, backbone, name, fast_stem=False):
    return tmetrics.Metrics(_Data.metric_source, backbone=backbone, batch_size=6,
                            compute_dtype=torch.float32, cache_dir=str(tmp_path / name),
                            num_classes=K, device="cpu", fast_stem=fast_stem)


def test_extract_features_replays_on_both_paths(tmp_path, monkeypatch, small_inception):
    eager = _metrics(tmp_path, small_inception, "eager")
    assert eager.program is None
    monkeypatch.setattr(tmetrics, "graph_for", _as_on_the_card)
    for fast_stem in (False, True):
        m = _metrics(tmp_path, small_inception, f"graph{fast_stem}", fast_stem)
        # the host set: 16 rows in 3 slab batches of 6, the last padded
        assert (m.program.captures, m.program.replays) == (1, 2)
        want = eager.real_features if not fast_stem else _eager(
            m, "program", lambda: m._extract_u8(_Data.images_u8))
        assert np.array_equal(m.real_features, want)
        fake = torch.rand(10, 16, 16, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
        got = m.extract_features(fake)  # the device path: 2 batches of 6
        assert m.program.replays == 4
        assert np.array_equal(got, _eager(m, "program", lambda: m.extract_features(fake)))


EVALS = {"cgan": (True, []), "int8": (False, ["--quant", "int8"]),
         "truncated": (False, ["--truncation", "0.6"])}


@pytest.mark.parametrize("case", sorted(EVALS))
def test_evaluate_equals_the_eager_route(tmp_path, monkeypatch, small_inception, case):
    conditional, flags = EVALS[case]
    _, path = _ckpt(tmp_path, conditional)
    monkeypatch.setattr(gan_trainer, "EVAL_CHUNK", 30)  # CGAN's 100 rows: 30, 30, 30, 10
    argv = ["--ckpt", path, "--device", "cpu", "--compute_dtype", "float32",
            "--sample_count", "12", "--kid", "1", "--prdc", "1", *flags]
    results, programs = [], []
    real = gan_trainer.eval_program
    for graph in (None, EagerGraph):
        monkeypatch.setattr(tevaluate, "graph_for", lambda *a, g=graph, **k: (g, ""))
        monkeypatch.setattr(tmetrics, "graph_for", lambda *a, g=graph, **k: (g, ""))
        monkeypatch.setattr(tevaluate, "eval_program",
                            lambda *a: programs.append(real(*a)) or programs[-1])
        m = _metrics(tmp_path, small_inception, f"m{len(results)}")
        results.append(tevaluate.evaluate(tevaluate.get_args(argv), metrics=m))
    assert results[0] == results[1] and np.isfinite(results[0]["fid"])
    assert programs[0] is None
    # CGAN: one capture per chunk shape, the two later 30-row chunks replayed
    assert (programs[1].captures, programs[1].replays) == ((2, 2) if conditional else (1, 0))
