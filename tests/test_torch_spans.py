"""The port's spans (``jckx_torch/utils/spans.py``) on the CPU: off without
a profiler; under ``torch.profiler`` nested records with their parent, root,
``n`` and self time, and ``jckx_torch.*`` user annotations in the Chrome
trace around the aten ops they enclose; a served request and a train launch
as their layers' spans (the tiny setup of tests/test_step_torch_parity.py:
16², width 8, batch 8, f32, ``EagerGraph`` in place of a CUDA graph); a
fine-tune launch (``inception_train.launch``, 75², batch 2, eager); the
benchmark's four readers of spans on synthetic span lists, and the
fine-tune cell's two readers of the device trace on synthetic kernels.
"""

import json
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jckx_torch import serve as tserve
from jckx_torch.configs import Config
from jckx_torch.metrics import inception_train
from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
from jckx_torch import utils
from jckx_torch.train import gan_trainer
from jckx_torch.utils import spans
from jckx_torch.utils.graphs import EagerGraph
from portbench import core
from portbench.layer_metrics._device import PEAK_HBM_BYTES
from portbench.trace import DeviceEvent, Trace
from torch_threads import one_torch_thread  # noqa: F401

GEO = GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)
BS = 8


@pytest.fixture(autouse=True)
def no_spans_left():
    spans.clear()
    yield
    spans.clear()


def _profiled(fn):
    """``fn()`` under a CPU profiler → (its answer, the spans, the Chrome
    trace's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = spans.recorded()
    spans.clear()
    return out, got, prof


def _named(got, name):
    return [s for s in got if s.name == spans.PREFIX + name]


def test_off_without_a_profiler_records_nothing(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) opened with spans off")

    monkeypatch.setattr(spans, "record_function", refused)
    assert spans.span("serve.sample", 4) is spans.OFF
    with spans.span("a", 1):
        with spans.span("b"):
            torch.ones(2) + 1
    assert spans.recorded() == []


def test_nested_spans_record_their_tree_under_the_profiler(tmp_path):
    def work():
        with spans.span("outer", 2):
            with spans.span("inner", 1):
                torch.ones(64, 64) @ torch.ones(64, 64)
            with spans.span("inner", 1):
                torch.ones(8).add_(1)

    _, got, prof = _profiled(work)
    (outer,), inner = _named(got, "outer"), _named(got, "inner")
    assert len(got) == 3 and outer.parent == 0 and outer.root == outer.id and outer.n == 2
    assert [(s.parent, s.root, s.n) for s in inner] == [(outer.id, outer.id, 1)] * 2
    assert all(outer.start_ns <= s.start_ns < s.end_ns <= outer.end_ns for s in inner)
    covered = spans.child_ns(got, "outer", "inner")
    assert covered == {outer.id: sum(s.ns for s in inner)}
    assert 0 < outer.ns - covered[outer.id] < outer.ns  # its self time

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = [e for e in events if str(e.get("name", "")).startswith(spans.PREFIX)]
    assert {e["cat"] for e in ann} == {"user_annotation"}
    assert sorted(e["name"] for e in ann) == ["jckx_torch.inner"] * 2 + ["jckx_torch.outer"]
    first = min((e for e in ann if e["name"] == "jckx_torch.inner"), key=lambda e: e["ts"])
    mm = [e for e in events if e.get("name") == "aten::matmul"]
    assert mm and all(first["ts"] <= e["ts"] and e["ts"] + e["dur"] <= first["ts"] + first["dur"]
                      for e in mm)  # on the aten ops' timeline, around them


def _in_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(out) == 1
    return out[0]


def test_each_thread_keeps_its_own_stack(monkeypatch):
    """Spans follow the profiler's switch in their own thread (torch's
    profiler records the thread that started it), and a thread's spans nest
    under its own: on with the switch forced on in every thread."""
    def side():
        with spans.span("side", 3) as s:
            return s

    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer"):
            assert _in_thread(side) is spans.OFF
    assert [s.name for s in spans.recorded()] == ["jckx_torch.outer"]
    spans.clear()
    monkeypatch.setattr(spans, "_profiling", lambda: True)
    with spans.span("outer") as outer:
        _in_thread(side)
    (got,) = _named(spans.recorded(), "side")
    assert got.parent == 0 and got.root == got.id != outer.id and got.n == 3


def _checkpoint(path):
    gen = torch.Generator().manual_seed(0)
    torch.save({"model_g": Generator(GEO, gen=gen).state_dict(),
                "model_d": Discriminator(GEO, gen=gen).state_dict()}, path)
    return str(path)


def test_a_served_request_is_one_tree_of_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(tserve, "graph_for", lambda *a, **k: (EagerGraph, ""))
    svc = tserve.GeneratorService(_checkpoint(tmp_path / "g.pt"), batch_size=BS,
                                  compute_dtype=torch.float32, device="cpu")
    svc.sample(BS, seed=1)  # the capture, outside the profiled request
    imgs, got, _ = _profiled(lambda: svc.sample(20, seed=2))
    assert imgs.shape == (20, 16, 16, 3)
    (root,) = _named(got, "serve.sample")
    assert root.parent == 0 and root.n == 20
    renders, drains = _named(got, "serve.render"), _named(got, "serve.drain")
    (assemble,) = _named(got, "serve.assemble")
    assert len(renders) == len(drains) == 3 and assemble.n == 20
    assert {(s.parent, s.root) for s in renders + drains + [assemble]} == {(root.id, root.id)}
    assert len(got) == 8


def _trainer(tmp_path):
    cfg = Config()
    for k, v in dict(dataset="synthetic", batch_size=BS, epoch=1, image_size=16, base_width=8,
                     z_dim=16, compute_dtype="float32", max_learning_rate=2e-4, log_every=2,
                     eval_every=0, ema_decay=0.5, sample_count=BS, log_file=0, device="cpu",
                     save_root=str(tmp_path), data_dir=str(tmp_path / "data"),
                     save_path=str(tmp_path / "run")).items():
        setattr(cfg, k, v)
    gen = torch.Generator().manual_seed(0)

    class Data:
        images_u8 = np.random.RandomState(0).randint(0, 256, (16, 16, 16, 3), np.uint8)
        labels_np = np.zeros(16, np.int32)
        num_classes = 10
        metric_source = (images_u8, labels_np)

    return gan_trainer.DCGANTrainer(cfg, Generator(GEO, gen=gen), Discriminator(GEO, gen=gen),
                                    Data())


def test_a_launch_is_one_span_over_its_steps(tmp_path, monkeypatch):
    monkeypatch.setattr(gan_trainer, "graph_for", lambda *a, **k: (EagerGraph, ""))
    tr = _trainer(tmp_path)
    idx = torch.arange(BS)

    def launch(k):
        return lambda: tr._launch([{"idx": idx}] * k)

    _, first, _ = _profiled(launch(1))  # the eager step and the capture
    (cap,) = _named(first, "graph.capture")
    assert cap.root == _named(first, "train.launch")[0].id and not _named(first, "superstep.replay")
    vals, got, _ = _profiled(launch(3))
    assert vals.shape[0] == 3 and tr.superstep.replays == 3
    (root,) = _named(got, "train.launch")
    assert root.parent == 0 and root.n == 3 and not _named(got, "graph.capture")
    feeds, replays = _named(got, "train.feed"), _named(got, "superstep.replay")
    assert len(feeds) == len(replays) == 3
    assert {(s.parent, s.n) for s in feeds + replays} == {(root.id, 1)}


def _synthetic():
    S = spans.Span
    p = spans.PREFIX
    return [S(p + "serve.render", 0, 2_000_000, 2, 1, 1, 1),
            S(p + "serve.render", 2_000_000, 3_000_000, 3, 1, 1, 1),
            S(p + "serve.drain", 3_000_000, 13_000_000, 4, 1, 1, 1),
            S(p + "serve.assemble", 13_000_000, 33_000_000, 5, 1, 1, 2),
            S(p + "serve.sample", 0, 34_000_000, 1, 0, 1, 2),
            S(p + "serve.render", 40_000_000, 45_000_000, 7, 6, 6, 1),
            S(p + "serve.drain", 45_000_000, 75_000_000, 8, 6, 6, 1),
            S(p + "serve.assemble", 75_000_000, 85_000_000, 9, 6, 6, 2),
            S(p + "serve.sample", 40_000_000, 86_000_000, 6, 0, 6, 2),
            S(p + "serve.render", 90_000_000, 95_000_000, 11, 10, 10, 1),
            S(p + "serve.sample", 90_000_000, 96_000_000, 10, 0, 10, 2),
            S(p + "serve.drain", 0, 99_000_000, 12, 0, 12, 1),  # no request around it
            S(p + "train.launch", 0, 30_000_000, 20, 0, 20, 3),
            S(p + "train.feed", 0, 1_000_000, 21, 20, 20, 1),
            S(p + "superstep.replay", 1_000_000, 17_000_000, 22, 20, 20, 1),
            S(p + "train.feed", 17_000_000, 17_500_000, 23, 20, 20, 1),
            S(p + "superstep.replay", 17_500_000, 29_000_000, 24, 20, 20, 1),
            S(p + "train.feed", 29_000_000, 29_300_000, 25, 20, 20, 1)]


@pytest.mark.parametrize("metric,want", [
    ("serve.render_ms", 5.0),      # per request 3, 5, 5 ms
    ("serve.drain_ms", 10.0),      # 10, 30, 0
    ("serve.assemble_ms", 10.0),   # 20, 10, 0
    ("train.host_ms_per_step", 1.8 / 3),  # the feeds, not the replays' enqueues
])
def test_the_span_readers_on_synthetic_spans(monkeypatch, metric, want):
    read = core.reader(metric)
    monkeypatch.setattr(spans, "recorded", _synthetic)
    assert read(None) == pytest.approx(want)
    monkeypatch.setattr(spans, "recorded", list)
    assert read(None) is None
    monkeypatch.delattr(utils, "spans")  # a program without the recorder
    monkeypatch.setitem(sys.modules, "jckx_torch.utils.spans", None)
    assert read(None) is None


def test_the_feed_reader_takes_a_finetune_launch_s_feeds(monkeypatch):
    """A fine-tune launch's feeds are ``train.feed`` spans made before its
    replays: ``train.host_ms_per_step`` reads them, and leaves the replays
    and the read out."""
    S, p = spans.Span, spans.PREFIX
    got = [S(p + "finetune.launch", 0, 30_000_000, 30, 0, 30, 2),
           S(p + "train.feed", 0, 2_000_000, 31, 30, 30, 1),
           S(p + "train.feed", 2_000_000, 3_000_000, 32, 30, 30, 1),
           S(p + "superstep.replay", 3_000_000, 15_000_000, 33, 30, 30, 1),
           S(p + "superstep.replay", 15_000_000, 20_000_000, 34, 30, 30, 1),
           S(p + "finetune.telemetry_read", 20_000_000, 30_000_000, 35, 30, 30, 2)]
    monkeypatch.setattr(spans, "recorded", lambda: got)
    assert core.reader("train.host_ms_per_step")(None) == pytest.approx(3.0 / 2)


def test_a_finetune_launch_is_one_span_over_its_steps():
    """A launch of K = ``--scan_steps`` steps: one ``finetune.launch`` (n =
    K) over K ``train.feed`` and the launch's one
    ``finetune.telemetry_read``; a shorter launch reads nothing; off the
    profiler, nothing is recorded."""
    args = inception_train.get_args(["--device", "cpu", "--compute_dtype", "float32",
                                     "--image_size", "75", "-b", "2", "--scan_steps", "2"])
    rng = np.random.RandomState(0)
    run = inception_train.prepare(args, rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8),
                                  np.arange(8, dtype=np.int32) % 4, 4, torch.device("cpu"))
    assert run.superstep is None and run.scan_steps == 2
    order = torch.arange(8).reshape(4, 2)
    (rows, read), got, _ = _profiled(lambda: inception_train.launch(run, order, 0, 2))
    assert rows.shape == (2, 2) and read.shape == (2, 2)
    (root,) = _named(got, "finetune.launch")
    feeds, (tel,) = _named(got, "train.feed"), _named(got, "finetune.telemetry_read")
    assert root.parent == 0 and root.n == 2 and len(feeds) == 2 and tel.n == 2
    assert {(s.parent, s.root, s.n) for s in feeds} == {(root.id, root.id, 1)}
    assert (tel.parent, tel.root) == (root.id, root.id) and len(got) == 4
    (_, read), got, _ = _profiled(lambda: inception_train.launch(run, order, 2, 1))
    assert read is None and not _named(got, "finetune.telemetry_read")
    inception_train.launch(run, order, 3, 1)
    assert spans.recorded() == []


def _kernels(*named):
    """A 1 ms window holding kernels (name, start µs, length µs) in turn."""
    return Trace((0.0, 1000.0), [DeviceEvent(n, "kernel", t, t + d) for n, t, d in named],
                 [("portbench.window", 0.0, 1000.0)])


def test_the_finetune_device_readers_on_synthetic_kernels():
    tr = _kernels(("void bn_act_vec<__nv_bfloat16, 1>", 0.0, 100.0),
                  ("max_pool_forward_nhwc<c10::BFloat16>", 100.0, 50.0),
                  ("avg_pool2d_backward_out_cuda_frame_nhwc<c10::BFloat16>", 150.0, 50.0),
                  ("sm90_xmma_fprop_implicit_gemm", 200.0, 200.0),
                  ("void bn_act_vec<__nv_bfloat16, 1>", 400.0, 100.0))
    facts = {"bn_act_bytes_per_step": 4.0e9, "bn_act_layers": 94}
    rec = SimpleNamespace(trace=tr, facts=facts, counts={"steps": 1})
    roof, pool = core.reader("finetune.bn_act_roofline"), core.reader("finetune.pool_pct")
    # two launches of an average 4e9 / 94 bytes at 3.35 TB/s against 200 µs of bn_act
    assert roof(rec) == pytest.approx(100.0 * 2 * 4.0e9 / 94 / PEAK_HBM_BYTES / 200e-6)
    assert pool(rec) == pytest.approx(100.0 * 100.0 / 500.0)  # of 500 µs busy
    plain = _kernels(("sm90_xmma_fprop_implicit_gemm", 0.0, 10.0))
    for nothing in (SimpleNamespace(trace=None, facts=facts, counts={}),
                    SimpleNamespace(trace=plain, facts=facts, counts={}),
                    SimpleNamespace(trace=Trace((0.0, 1.0)), facts=facts, counts={})):
        assert roof(nothing) is None and pool(nothing) is None
    assert roof(SimpleNamespace(trace=tr, facts={}, counts={})) is None


def test_the_finetune_backward_reader_on_synthetic_kernels():
    """``finetune.bn_bwd_roofline``: a step's two backwards (the sums, their
    combine, dx each) against 1.5 × an average map's forward bytes each;
    None without a kernel named ``bn_relu_bwd`` (the plain backward's
    reductions and elementwise kernels)."""
    ns = "void (anonymous namespace)::"
    tr = _kernels((ns + "bn_relu_bwd_sums<__nv_bfloat16, 8>", 0.0, 40.0),
                  (ns + "bn_relu_bwd_combine(float const*, float*, long, long)", 40.0, 5.0),
                  (ns + "bn_relu_bwd_dx<__nv_bfloat16, 8>", 45.0, 55.0),
                  ("sm90_xmma_dgrad_implicit_gemm", 100.0, 200.0),
                  (ns + "bn_relu_bwd_sums<__nv_bfloat16, 8>", 300.0, 40.0),
                  (ns + "bn_relu_bwd_combine(float const*, float*, long, long)", 340.0, 5.0),
                  (ns + "bn_relu_bwd_dx<__nv_bfloat16, 8>", 345.0, 55.0))
    facts = {"bn_act_bytes_per_step": 4.0e9, "bn_act_layers": 94}
    read = core.reader("finetune.bn_bwd_roofline")
    got = read(SimpleNamespace(trace=tr, facts=facts, counts={"steps": 1}))
    assert got == pytest.approx(100.0 * 2 * 1.5 * 4.0e9 / 94 / PEAK_HBM_BYTES / 200e-6)
    plain = _kernels(("reduce_kernel<512, 1>", 0.0, 10.0),
                     ("elementwise_kernel<128, 2>", 10.0, 10.0))
    assert read(SimpleNamespace(trace=plain, facts=facts, counts={})) is None
    assert read(SimpleNamespace(trace=tr, facts={}, counts={})) is None
