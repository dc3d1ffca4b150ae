"""The fine-tune's BN + ReLU backward as two registered operators
(``jckx_torch::bn_relu_bwd_sums``, ``jckx_torch::bn_relu_bwd_dx``,
``kernels/fused_bn_act.py``) on the CPU, on the tiny setup of
tests/test_step_torch_parity.py (16², width 8, batch 8, f32): their CPU
code, through ``bn_relu_train``'s backward, gives the earlier single
composition's dx, dgamma and dbeta bit for bit, whatever the incoming
gradient's layout (a channel slice of a concatenated gradient included),
and a mesh's all-reduce receives exactly the sums between the two. Also
the gradient's row view, the wrappers' refusals, the operators' fakes,
the build of every source at first load, and the launch counter through
replays. The kernels themselves run only on the card
(tests/test_torch_gpu.py).
"""

import os

import pytest
import torch

from jckx_torch.kernels import _build
from jckx_torch.kernels import fused_bn_act as tfba
from jckx_torch.ops import norm
from jckx_torch.train.superstep import Superstep
from jckx_torch.utils.graphs import EagerGraph

N, C, SIDE = 8, 8, 16  # batch, width, side
EPS = 1e-3


def _earlier_backward(x, dout, a, sh, inv, mean, mesh):
    """``_BNReLUTrain.backward`` as one composition, before it became two
    operators: → (dx, dgamma, dbeta)."""
    axes = (0, 2, 3)
    n = x.numel() // a.numel()
    xf = x.float()
    pos = xf * a[:, None, None] + sh[:, None, None] > 0.0
    dz = torch.where(pos, dout.float(), 0.0)
    sums = torch.stack([dz.sum(axes), (dz * xf).sum(axes)])
    dbeta = sums[0]
    dgamma = inv * (sums[1] - mean * dbeta)
    if mesh is not None:
        sums = mesh.all_reduce(sums)
        n *= mesh.size
    dbeta_all = sums[0]
    dgamma_all = inv * (sums[1] - mean * dbeta_all)
    dx = a[:, None, None] * (dz - (dbeta_all / n)[:, None, None]
                             - (xf - mean[:, None, None]) * (inv * dgamma_all / n)[:, None, None])
    return dx.to(x.dtype), dgamma, dbeta


class StandInMesh:
    """Two ranks that hold the same rows: an all-reduce doubles, and each
    call is recorded with its tensor."""

    size = 2

    def __init__(self, events):
        self.events = events

    def axis_size(self, axis="data"):
        return 2

    def all_reduce(self, t, axis="data"):
        self.events.append(("all_reduce", t))
        return t * 2


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(N, C, SIDE, SIDE, generator=g) * 2 + 0.5).contiguous(
        memory_format=torch.channels_last)
    scale = torch.rand(C, generator=g) + 0.5
    bias = torch.randn(C, generator=g)
    grad = torch.randn(N, 3 * C, SIDE, SIDE, generator=g)
    return x, scale, bias, grad


@pytest.mark.parametrize("mesh", [False, True], ids=["one", "stand-in"])
@pytest.mark.parametrize("layout", ["channels_last", "nchw", "channel_slice"])
def test_operators_on_cpu_equal_the_earlier_composition(layout, mesh, monkeypatch):
    x, scale, bias, grad = _inputs()
    events = []
    m = StandInMesh(events) if mesh else None
    for name in ("bn_relu_bwd_sums_op", "bn_relu_bwd_dx_op"):
        real = getattr(norm, name)

        def spy(*args, real=real, name=name):
            out = real(*args)
            events.append((name, out))
            return out

        monkeypatch.setattr(norm, name, spy)
    xx = x.clone().requires_grad_(True)
    s, b = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    out, _, _ = norm.bn_relu_train(xx, s, b, EPS, m)
    if layout == "channel_slice":  # out is the middle of three concatenated maps
        side = torch.zeros(N, C, SIDE, SIDE).contiguous(memory_format=torch.channels_last)
        cat = torch.cat([side, out, side], 1)
        g = grad.contiguous(memory_format=torch.channels_last)
        cat.backward(g)
        dout = g[:, C:2 * C]
        assert dout.stride() == (SIDE * SIDE * 3 * C, 1, SIDE * 3 * C, 3 * C)
    else:
        dout = grad[:, :C].clone()
        if layout == "channels_last":
            dout = dout.contiguous(memory_format=torch.channels_last)
        out.backward(dout)
    del events[:-3 if mesh else -2]  # the forward's all-reduce aside
    ref_mesh = StandInMesh([]) if mesh else None
    mean, _, inv, a, sh = tfba._terms(x, scale, bias, EPS, ref_mesh)
    want = _earlier_backward(x, dout, a, sh, inv, mean, ref_mesh)
    for got, ref in zip((xx.grad, s.grad, b.grad), want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    names = [e[0] for e in events]
    if mesh:
        assert names == ["bn_relu_bwd_sums_op", "all_reduce", "bn_relu_bwd_dx_op"]
        assert events[1][1] is events[0][1] and events[0][1].shape == (2, C)
        assert torch.equal(events[0][1], tfba.bn_relu_bwd_sums_op(x, dout, a, sh))
    else:
        assert names == ["bn_relu_bwd_sums_op", "bn_relu_bwd_dx_op"]


@pytest.mark.parametrize("layout", ["channels_last", "channel_slice", "rows", "row_slice"])
def test_gradient_rows_views_equally_spaced_rows(layout):
    g = torch.randn(N, 3 * C, SIDE, SIDE).contiguous(memory_format=torch.channels_last)
    t = {"channels_last": g[:, :C].contiguous(memory_format=torch.channels_last),
         "channel_slice": g[:, C:2 * C],
         "rows": g[0, :C].reshape(C, -1).t().contiguous(),
         "row_slice": tfba._rows(g)[:, 5:5 + C]}[layout]
    rows = tfba._gradient_rows(t)
    assert rows.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
    assert rows.stride(1) == 1 and torch.equal(rows, tfba._rows(t))


@pytest.mark.parametrize("layout", ["nchw", "strided_rows", "channel_stride"])
def test_gradient_rows_copies_any_other_layout(layout):
    g = torch.randn(N, 2 * C, SIDE, SIDE)
    t = {"nchw": g[:, :C],
         "strided_rows": g[:, :C].contiguous(memory_format=torch.channels_last)[:, :, ::2],
         "channel_stride": g.contiguous(memory_format=torch.channels_last)[:, ::2]}[layout]
    rows = tfba._gradient_rows(t)
    assert rows.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    assert rows.is_contiguous() and torch.equal(rows, tfba._rows(t.contiguous()))


def _vec(n=C, **kw):
    return torch.zeros(n, **kw)


@pytest.mark.parametrize("args, match", [
    ((torch.zeros(64, C, dtype=torch.float64), torch.zeros(64, C, dtype=torch.float64)),
     "float32 or"),
    ((torch.zeros(64, C), torch.zeros(64, C, dtype=torch.bfloat16)), "one shape"),
    ((torch.zeros(64, C), torch.zeros(32, C)), "one shape"),
    ((torch.zeros(C, 64).t(), torch.zeros(64, C)), "contiguous"),
    ((torch.zeros(0, C), torch.zeros(0, C)), "non-empty"),
    ((torch.zeros(N, C, 4, 4), torch.zeros(N, C, 4, 4)), "channels_last"),
    ((torch.zeros(64, C), torch.zeros(64, C), _vec(C - 1)), "per-channel"),
    ((torch.zeros(64, C), torch.zeros(64, C), _vec(dtype=torch.bfloat16)), "per-channel"),
    ((torch.zeros(64, C), torch.zeros(64, C)), "CUDA"),
    ((torch.zeros(64, C, dtype=torch.bfloat16),) * 2, "CUDA"),
])
def test_backward_wrappers_refuse_what_the_kernels_do_not_take(args, match):
    x, dout, *bad = args
    vecs = [bad[0] if bad else _vec()] + [_vec()] * 4
    before = tfba.BWD_LAUNCHES
    with pytest.raises(ValueError, match=match):
        tfba.bn_relu_bwd_sums(x, dout, *vecs[:2])
    with pytest.raises(ValueError, match=match):
        tfba.bn_relu_bwd_dx(x, dout, *vecs)
    assert tfba.BWD_LAUNCHES == before


def test_backward_operators_have_fakes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(N, C, SIDE, SIDE).contiguous(memory_format=torch.channels_last)
        v = torch.empty(C)
        sums = tfba.bn_relu_bwd_sums_op(x, x, v, v)
        dx = tfba.bn_relu_bwd_dx_op(x, x, v, v, v, v, v)
    assert sums.shape == (2, C) and sums.dtype == torch.float32
    assert dx.shape == x.shape and dx.is_contiguous(memory_format=torch.channels_last)


def test_first_load_builds_every_source_at_once(monkeypatch):
    """The first ``load`` of any kernel asks ``build`` for every source in
    one call (its nvcc processes start together), the backward's too."""
    asked = []

    def build(names=None):
        asked.append(names)
        return {n: f"/lib{n}.so" for n in _build.sources()}

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    assert _build.load("fused_bn_act") == "/libfused_bn_act.so"
    assert _build.load("bn_relu_bwd") == "/libbn_relu_bwd.so"
    assert asked == [None, None] and "bn_relu_bwd" in _build.sources()
    assert _build.library_path("bn_relu_bwd") != _build.library_path("bn_moments")


def test_an_edited_header_builds_its_includers_anew(tmp_path, monkeypatch):
    """A library's name hashes the headers beside its source (the sums'
    grid and combine, ``csrc/_bn_sums.cuh``, are in both sums' sources):
    an edited header names a new library, so a stale one is never loaded;
    an edited source names a new one for that source alone."""
    for f, text in (("one.cu", "a"), ("two.cu", "b"), ("shared.cuh", "c")):
        (tmp_path / f).write_text(text)
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = {n: _build.library_path(n) for n in _build.sources()}
    assert sorted(before) == ["one", "two"] and before["one"] != before["two"]
    (tmp_path / "shared.cuh").write_text("c, edited")
    after = {n: _build.library_path(n) for n in _build.sources()}
    assert all(after[n] != before[n] for n in before)
    (tmp_path / "one.cu").write_text("a, edited")
    assert _build.library_path("one") != after["one"]
    assert _build.library_path("two") == after["two"]
    assert "_bn_sums.cuh" in os.listdir(os.path.join(os.path.dirname(_build.__file__), "csrc"))


def test_backward_launches_are_added_per_replay():
    """A toy body that counts one backward (three launches) and one
    normalize launch: a warm step counts its own, a capture takes back what
    its Python counted, each replay adds them."""
    def body(x):
        tfba.add_launches(1, 0, 3)
        return x["v"] + 1

    ss = Superstep(body, torch.device("cpu"), EagerGraph)
    before = tfba.launch_counts()
    ss.replay(4, lambda j: {"v": torch.tensor([float(j)])})
    assert [a - b for a, b in zip(tfba.launch_counts(), before)] == [4, 0, 12]
