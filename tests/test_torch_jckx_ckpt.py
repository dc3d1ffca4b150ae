"""jckx ``.ckpt`` files read by the port without JAX
(jckx_torch/checkpoint/msgpack.py, jckx_torch/checkpoint/jckx_ckpt.py,
``load_checkpoint``), on the CPU.

- The decoder gives every leaf of ``flax.serialization.msgpack_restore``
  bit for bit, on jckx's DCGAN and CGAN states with and without EMA at the
  tiny size and once at the full 64² / width 64 geometry (init only), on
  arrays flax splits into chunks, and on flax's other extension types.
- Malformed bytes raise ``ValueError`` naming the file and the place.
- The fixture (tests/data/jckx_ckpt/, written by jckx's trainer through
  ``make_fixture.py``): the port's ``convert`` to ``.pt`` equals what
  ``python -m jckx.convert`` writes from it, tensor for tensor; ``serve``
  renders within 1 LSB of jckx's served renders; ``evaluate`` and
  ``inspect`` read it; ``train --resume`` continues its run dir from
  jckx's weights, Adam state and step; and ``make_fixture.py`` writes the
  committed files again: the same names, configs and inputs, and floats
  within ``FIXTURE_ULPS`` (XLA's CPU code follows the host's instruction
  set, so the last bits of a retrained run are the host's).
"""

import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from jckx.models.dcgan import GANGeometry as JGeometry
from jckx.serve import tanh_to_u8
from jckx.train.state import make_template_state
from jckx_torch import convert as tconvert
from jckx_torch import inspect as tinspect
from jckx_torch.checkpoint.checkpoint import load_checkpoint, load_generator
from jckx_torch.checkpoint.msgpack import unpackb
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.configs import get_arg_parse
from jckx_torch.evaluate import evaluate
from jckx_torch.evaluate import get_args as eval_args
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.serve import GeneratorService
from jckx_torch.train import main as tmain
from test_torch_cgan_trainer import StubMetrics as CGANStubMetrics
from test_torch_trainer import StubMetrics
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jckx_ckpt")
TINY = JGeometry(z_dim=16, image_size=16, channels=3, base_width=8)
FILES = {"dcgan": os.path.join(FIXTURE, "dcgan", "run", "latest.ckpt"),
         "cgan": os.path.join(FIXTURE, "cgan", "run", "latest.ckpt")}


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(want).view(np.int16).tobytes()
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _state_bytes(geo, conditional, ema):
    return serialization.to_bytes(make_template_state(geo, conditional=conditional,
                                                      num_classes=10, with_ema=ema))


@pytest.mark.parametrize("family,ema,geo", [
    ("DCGAN", False, TINY), ("DCGAN", True, TINY), ("CGAN", False, TINY), ("CGAN", True, TINY),
    ("DCGAN", True, JGeometry())])
def test_decoder_equals_flax(family, ema, geo):
    data = _state_bytes(geo, family == "CGAN", ema)
    _assert_same_tree(unpackb(data, "state.ckpt"), serialization.msgpack_restore(data))


def test_decoder_reads_chunked_arrays_and_flax_ext_types(monkeypatch):
    data = _state_bytes(TINY, True, True)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)
    chunked = _state_bytes(TINY, True, True)
    assert b"__msgpack_chunked_array__" in chunked and len(chunked) > len(data)
    _assert_same_tree(unpackb(chunked), serialization.msgpack_restore(chunked))
    _assert_same_tree(unpackb(chunked), serialization.msgpack_restore(data))

    tree = {"bf16": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3),
            "npscalar": np.float32(2.5), "i32": np.int32(-7), "complex": complex(1.5, -2.0),
            "none": None, "list": [1, -3, 2 ** 40, 1.5, True, "s", b"bin"],
            "empty": np.zeros((0, 4), np.int8), "u64": np.arange(3, dtype=np.uint64)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4)
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(unpackb(data), serialization.msgpack_restore(data))


def test_malformed_bytes_name_the_file_and_the_place(tmp_path):
    for payload, match in ((b"\x82\xa5flax", r"x\.ckpt: truncated msgpack .* at <key>"),
                           (b"\x81\xa1a\xd4\x07\x00", r"x\.ckpt: unknown msgpack extension type 7 .* at a"),
                           (b"\x81\xa1a\xc1", r"x\.ckpt: byte 0xc1 is not a msgpack type at a"),
                           (b"\xc0\xc0", "trailing bytes")):
        with pytest.raises(ValueError, match=match):
            unpackb(payload, "x.ckpt")
    bad = serialization.msgpack_serialize({"p": {"w": np.zeros(3, np.float32)}})
    bad = bad.replace(b"float32", b"float99")
    with pytest.raises(ValueError, match=r"unknown array dtype 'float99' at p/w"):
        unpackb(bad, "x.ckpt")
    for name, payload in (("trunc.ckpt", b"\x82\xa5flax"),
                          ("other.ckpt", serialization.msgpack_serialize({"a": 1}))):
        (tmp_path / name).write_bytes(payload)
        with pytest.raises(ValueError, match=f"{name} is a malformed jckx checkpoint"):
            load_checkpoint(str(tmp_path / name))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "missing.ckpt"))


def _jckx_convert(src, dst, *extra):
    from jckx.convert import convert, get_args

    return convert(get_args(["--src", src, "--dst", dst, *extra]))


def _equal(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in b:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, torch.Tensor) and path.endswith("num_batches_tracked"):
        # jckx's export lifts this 0-d buffer to shape (1,) (np.ascontiguousarray);
        # torch loads either shape into a 0-d buffer
        assert a.dtype == b.dtype and a.numel() == b.numel() == 1 and int(a) == int(b), path
    elif isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("family,use_ema", [("dcgan", False), ("dcgan", True), ("cgan", False)])
def test_convert_equals_jckx_convert(tmp_path, family, use_ema):
    flags = ["--use_ema"] if use_ema else []
    _jckx_convert(FILES[family], str(tmp_path / "jckx.pt"), *flags)
    info = tconvert.convert(tconvert.get_args(
        ["--src", FILES[family], "--dst", str(tmp_path / "port.pt")] + flags))
    assert info["step"] == 4 and info["conditional"] == (family == "cgan")
    _equal(torch.load(tmp_path / "port.pt", weights_only=True),
           torch.load(tmp_path / "jckx.pt", weights_only=False))


@pytest.mark.parametrize("family", ["dcgan", "cgan"])
def test_serve_renders_within_one_lsb_of_jckx(family):
    z = torch.from_numpy(np.load(os.path.join(FIXTURE, "z.npy")))
    want = np.asarray(tanh_to_u8(jnp.asarray(np.load(os.path.join(FIXTURE, f"{family}_renders.npy")))))
    svc = GeneratorService(FILES[family], batch_size=len(z), compute_dtype=torch.float32,
                           device="cpu")
    assert svc.step == 4 and svc.used_ema == (family == "dcgan")
    labels = torch.from_numpy(np.load(os.path.join(FIXTURE, "cgan_labels.npy")))
    got = svc.render(z, labels if family == "cgan" else None).numpy()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape == (16, 16, 16, 3)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_evaluate_and_inspect_read_the_fixture(tmp_path, capsys):
    r = evaluate(eval_args(["--ckpt", FILES["dcgan"], "--device", "cpu", "--compute_dtype",
                            "float32", "--sample_count", "16"]), metrics=StubMetrics())
    assert r["step"] == 4 and r["n"] == 16 and np.isfinite(r["fid"])
    r = evaluate(eval_args(["--ckpt", FILES["cgan"], "--device", "cpu", "--compute_dtype",
                            "float32"]), metrics=CGANStubMetrics())
    assert r["step"] == 4 and r["n"] == 100 and np.isfinite(r["intra_fid"])

    info = tinspect.inspect_path(FILES["dcgan"])
    with open(os.path.join(FIXTURE, "dcgan", "run", "config.json")) as f:
        stored = json.load(f)
    assert info["kind"] == "jckx checkpoint (flax msgpack)" and info["sidecar_present"]
    assert (info["step"], info["ema"], info["conditional"]) == (4, True, False)
    assert info["geometry"] == {k: stored[k] for k in ("z_dim", "image_size", "channels",
                                                       "base_width")}
    assert info["params_g"] == 6576 and info["params_d"] == 2736 and info["logged_losses"] == 4
    assert info["opt_moments"] == 2 * (6576 + 2736)
    assert tinspect.main(["--ckpt", FILES["cgan"]]) == 0
    assert json.loads(capsys.readouterr().out)["num_classes"] == 10


def test_loaded_dict_carries_jckx_state():
    tree = serialization.msgpack_restore(open(FILES["dcgan"], "rb").read())
    ck = load_checkpoint(FILES["dcgan"])
    geo = GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)
    _equal(ck["model_g"], params_from_jax(tree["params_g"], geo, "g"))
    _equal(ck["ema_g"], params_from_jax(tree["ema_g"], geo, "g"))
    assert (ck["step"], ck["seed"]) == (4, 12345)
    assert ck["jckx_rng"] == [int(v) for v in tree["rng"]]
    adam = tree["opt_d"]["0"]
    mu = params_from_jax(adam["mu"], geo, "d")
    names = [k for k in mu if not k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked"))]
    for i, name in enumerate(names):
        st = ck["optimizer_d"]["state"][i]
        assert st["step"] == float(adam["count"]) == 4.0
        assert torch.equal(st["exp_avg"], mu[name])
    assert ck["serve_config"]["ema"] and ck["bests"]["fid"] == 50.0 and len(ck["losses"]) == 4
    lg = load_generator(FILES["dcgan"])
    assert lg.used_ema and lg.step == 4 and lg.num_classes == 100


def test_resume_continues_a_jckx_run_dir(tmp_path):
    shutil.copytree(os.path.join(FIXTURE, "dcgan"), tmp_path / "dcgan")
    ck = load_checkpoint(FILES["dcgan"])
    cfg = get_arg_parse(["--resume", "-pm", "run", "-e", "2", "--device", "cpu",
                         "--save_root", str(tmp_path), "--data_dir", str(tmp_path / "data")])
    assert cfg.inherited_from and (cfg.z_dim, cfg.ema_decay, cfg.eval_every) == (16, 0.9, 4)
    assert cfg.mesh_shape == "" and cfg.mesh_axes == "data"
    try:
        from jckx_torch.train.gan_trainer import DCGANTrainer
        from jckx_torch.models.dcgan import Discriminator, Generator

        probe = DCGANTrainer(cfg, Generator(GANGeometry(16, 16, 3, 8)),
                             Discriminator(GANGeometry(16, 16, 3, 8)),
                             _data(cfg), metrics=StubMetrics())
        assert probe.state.step == 4
        _equal(probe.state.G.state_dict(), ck["model_g"])
        assert probe.state.opt_d.state_dict()["state"][0]["exp_avg"].equal(
            ck["optimizer_d"]["state"][0]["exp_avg"])
        MainLogger.reset()
        cfg = get_arg_parse(["--resume", "-pm", "run", "-e", "2", "--device", "cpu",
                             "--save_root", str(tmp_path), "--data_dir", str(tmp_path / "data")])
        tr = tmain.run(cfg, metrics=StubMetrics())
    finally:
        MainLogger.reset()
    assert tr.state.step == 8 and tr.evals == [8]
    latest = tmp_path / "dcgan" / "run" / "latest.ckpt"
    assert zipfile.is_zipfile(latest)  # the port's own file now
    assert load_checkpoint(str(latest))["step"] == 8
    assert len(load_checkpoint(str(latest))["losses"]) == 8
    logs = [p for p in os.listdir(latest.parent) if p.endswith(".log")]
    text = "".join(open(latest.parent / p).read() for p in logs)
    assert "written by jckx" in text and "not from jckx's rng" in text


def _data(cfg):
    from jckx_torch.data.pipeline import DCGANDataPreprocessor

    return DCGANDataPreprocessor(cfg)


# A regenerated float may differ from the committed one by this many f32
# ulps of its array's largest magnitude (of its own magnitude for a JSON
# scalar). On an AVX-512 host the worst leaf of the checkpoints was 15 ulps
# off (params_g/bn1_bias), the renders at most 7.8e-8 (< 1 ulp of 1.0).
FIXTURE_ULPS = 64


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_floats_close(got, want, where):
    """Equal, but floats (arrays or scalars) within ``FIXTURE_ULPS``."""
    if isinstance(want, torch.Tensor):
        got, want = got.float().numpy(), want.float().numpy()
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert (got.dtype, got.shape) == (want.dtype, want.shape), where
        if want.dtype.kind != "f":
            np.testing.assert_array_equal(got, want, err_msg=where)
            return
        scale = np.float32(np.abs(want).max()) if want.size else np.float32(0)
        tol = FIXTURE_ULPS * float(np.spacing(np.maximum(scale, np.float32(np.finfo(np.float32).tiny))))
        err = float(np.abs(got.astype(np.float64) - want).max()) if want.size else 0.0
        assert err <= tol, f"{where}: {err} apart, allowed {tol}"
    elif isinstance(want, float):
        assert isinstance(got, float), where
        tol = FIXTURE_ULPS * float(np.spacing(np.float32(abs(want))))
        assert abs(got - want) <= tol, f"{where}: {got} vs {want}"
    else:
        assert type(got) is type(want) and got == want, f"{where}: {got!r} vs {want!r}"


def _assert_trees_close(got, want, where):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert list(g) == list(w), f"{where}: the trees' keys differ"
    for k in w:
        _assert_floats_close(g[k], w[k], where + k)


def test_make_fixture_rewrites_the_committed_files(tmp_path):
    """The script regenerates the committed fixture: the same file names;
    ``config.json``, ``z.npy`` and ``cgan_labels.npy`` byte for byte; each
    ``latest.ckpt`` decoded by the port's msgpack reader to the same keys,
    dtypes and shapes with its floats within ``FIXTURE_ULPS``, and so are
    the parsed ``.json`` sidecars and the renders."""
    out = tmp_path / "fx"
    subprocess.run([sys.executable, os.path.join(FIXTURE, "make_fixture.py"), "--out", str(out)],
                   check=True, capture_output=True, timeout=300)
    committed = sorted(os.path.relpath(os.path.join(d, f), FIXTURE)
                       for d, _, fs in os.walk(FIXTURE) for f in fs
                       if f != "make_fixture.py" and "__pycache__" not in d)
    written = sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out)
                     for f in fs)
    assert written == committed
    for rel in committed:
        with open(os.path.join(FIXTURE, rel), "rb") as a, open(out / rel, "rb") as b:
            want, got = a.read(), b.read()
        name = os.path.basename(rel)
        if name in ("config.json", "z.npy", "cgan_labels.npy"):
            assert got == want, rel
        elif name.endswith(".ckpt"):
            _assert_trees_close(unpackb(got, rel), unpackb(want, rel), rel)
        elif name.endswith(".json"):
            _assert_trees_close(json.loads(got), json.loads(want), rel)
        else:
            assert name.endswith("_renders.npy"), rel
            _assert_floats_close(np.load(out / rel), np.load(os.path.join(FIXTURE, rel)), rel)
