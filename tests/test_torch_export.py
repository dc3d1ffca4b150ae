"""The port's sealed artifacts (jckx_torch/export.py and the ``.pt2`` path of
jckx_torch/serve.py) on the CPU, against jckx's ``.jaxexp`` artifacts
(jckx/export.py) exported from the same reference ``.pt`` at the tiny
geometry (16², base width 8, z 16, batch 8, f32).

- A seed's renders, through ``load_exported``, within 1 LSB of jckx's
  artifact for the same seed (the z inside both programs is
  ``jax.random.normal(PRNGKey(seed))``; jckx_torch/rng.py).
- ``ArtifactService``: jckx's per-request seeding and its host-side label
  draw, so whole requests agree with jckx's service within 1 LSB.
- The int8 artifact equals the port's int8 sampler bit for bit on the z of
  the seed; the sidecar carries jckx's keys.
- The program holds one ``jckx_torch::bn_moments`` and one
  ``jckx_torch::normalize_act`` node per BN layer: on the card it launches
  the statistics' and the fused kernels, as the service does.
- The errors: labels on a DCGAN artifact, none on a CGAN one; the flags
  that a sealed artifact refuses; ``.jaxexp`` refused by name; the
  daemon's ``/interpolate`` a 400; ``--watch`` reloads a replaced ``.pt2``.
"""

import json
import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jckx import export as jexport
from jckx_torch import export as texport
from jckx_torch import rng
from jckx_torch import serve as tserve
from test_torch_serve import GEO, _ckpt
from test_torch_serve_http import Daemon

BS = 8


def _u8_within_1(a, b):
    a, b = np.asarray(a).astype(np.int16), np.asarray(b).astype(np.int16)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a - b).max() <= 1


@pytest.fixture(scope="module", params=[False, True], ids=["dcgan", "cgan"])
def artifacts(request, tmp_path_factory):
    """(reference .pt, jckx's .jaxexp, the port's .pt2) of one family."""
    tmp = tmp_path_factory.mktemp("cgan" if request.param else "dcgan")
    _, path = _ckpt(tmp, conditional=request.param)
    jexport.export_generator(path, path + ".jaxexp", batch_size=BS, compute_dtype=jnp.float32,
                             platforms=("cpu",))
    info = texport.export_generator(path, path + "2", batch_size=BS,
                                    compute_dtype=torch.float32, device="cpu")
    return request.param, path, path + ".jaxexp", path + "2", info


def test_sidecar_has_jckx_keys(artifacts):
    cond, _, jpath, tpath, info = artifacts
    with open(jpath + ".json") as f:
        ref = json.load(f)
    assert set(info) == set(ref)
    assert info["platforms"] == ["cpu"] and ref["platforms"] == ["cpu"]
    for k in ("step", "ema_weights", "batch_size", "conditional", "num_classes", "z_dim",
              "image_size", "channels", "base_width", "compute_dtype", "quant", "inputs", "output"):
        assert info[k] == ref[k], k
    assert texport.read_sidecar(tpath) == info


def test_renders_match_jckx_artifact(artifacts):
    cond, _, jpath, tpath, _ = artifacts
    ours, ref = texport.load_exported(tpath, device="cpu"), jexport.load_exported(jpath)
    labels = np.arange(BS) % 10 if cond else None
    for seed in (0, 7, 123456, 2**31 - 2):
        got = ours(seed, labels)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (BS, 16, 16, 3)
        _u8_within_1(got.numpy(), ref(seed, labels))
    with pytest.raises(ValueError, match="takes no labels" if not cond else "pass labels"):
        ours(0, None if cond else np.zeros(BS))


def test_artifact_service_seeding_and_labels_match_jckx(artifacts):
    cond, _, jpath, tpath, _ = artifacts
    ours = texport.ArtifactService(tpath, seed=3, device="cpu")
    ref = jexport.ArtifactService(jpath, seed=3)
    assert (ours.batch_size, ours.conditional, ours.step, ours.geo.image_size) == (
        ref.batch_size, ref.conditional, ref.step, ref.geo.image_size)
    assert ours.num_classes == ref.num_classes == (10 if cond else 0)
    for n in (5, 20):  # the counter advances per request, as jckx's
        _u8_within_1(ours.sample(n), ref.sample(n))
    _u8_within_1(ours.sample(11, seed=42), ref.sample(11, key=42))
    if cond:
        _u8_within_1(ours.sample(10, labels=[3, 1]), ref.sample(10, labels=[3, 1]))
        want = np.random.default_rng([99, 2]).integers(0, 10, size=BS, dtype=np.int32)
        np.testing.assert_array_equal(ours.batch_labels(99, 2), want)
        with pytest.raises(ValueError, match="labels must lie"):
            ours.sample(2, labels=[10])
    else:
        with pytest.raises(ValueError, match="unconditional"):
            ours.sample(2, labels=[1])


def test_int8_artifact_equals_the_int8_sampler(tmp_path):
    _, path = _ckpt(tmp_path)
    dst = str(tmp_path / "q.pt2")
    info = texport.export_generator(path, dst, batch_size=BS, compute_dtype=torch.float32,
                                    quant="int8", device="cpu")
    assert info["quant"] == "int8"
    sample = texport.load_exported(dst, device="cpu")
    svc = tserve.GeneratorService(path, batch_size=BS, compute_dtype=torch.float32, quant="int8",
                                  device="cpu")
    for seed in (0, 5):
        z = rng.normal_from_seed(seed, (BS, GEO.z_dim))
        assert torch.equal(sample(seed), svc.render(z))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_artifact_holds_the_kernel_operator_per_bn_layer(tmp_path, quant):
    _, path = _ckpt(tmp_path)
    dst = str(tmp_path / "g.pt2")
    texport.export_generator(path, dst, batch_size=BS, compute_dtype=torch.float32, quant=quant,
                             device="cpu")
    program = torch.export.load(dst)
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.jckx_torch.normalize_act.default) == GEO.n_up
    assert ops.count(torch.ops.jckx_torch.bn_moments.default) == GEO.n_up


def test_serving_a_pt2_and_its_refusals(artifacts, tmp_path, capsys):
    cond, path, _, tpath, _ = artifacts
    out = str(tmp_path / "g.png")
    tserve.main(tserve.get_args(["--ckpt", tpath, "-n", "10", "-o", out, "--device", "cpu"]
                                + (["--labels", "1,2"] if cond else [])))
    assert "wrote 10 samples" in capsys.readouterr().out and os.path.getsize(out) > 0
    for flag in (["--batch_size", "4"], ["--quant", "int8"], ["--subpixel", "1"],
                 ["--truncation", "0.5"], ["--interpolate", "1,2"], ["--image_size", "16"],
                 ["--num_classes", "10"], ["--conditional"]):
        with pytest.raises(SystemExit, match="sealed artifact"):
            tserve.main(tserve.get_args(["--ckpt", tpath, "--device", "cpu"] + flag))
    for argv in (["--ckpt", path + ".jaxexp"], ["--ckpt", path + ".jaxexp", "--listen", "0"]):
        with pytest.raises(SystemExit, match="python -m jckx.serve"):
            tserve.main(tserve.get_args(argv + ["--device", "cpu"]))
    with pytest.raises(ValueError, match="ArtifactService"):
        tserve.GeneratorService(tpath, device="cpu")


def test_daemon_serves_an_artifact_and_watch_reloads_it(tmp_path):
    for sub in ("a", "b"):
        os.makedirs(tmp_path / sub)
    (_, a), (_, b) = _ckpt(tmp_path / "a"), _ckpt(tmp_path / "b")
    sd = torch.load(b, weights_only=True)
    sd["model_g"] = {k: v * 1.5 if k.endswith("weight") else v for k, v in sd["model_g"].items()}
    torch.save(sd, b)
    served = str(tmp_path / "served.pt2")
    texport.export_generator(a, served, batch_size=BS, compute_dtype=torch.float32, device="cpu")
    texport.export_generator(b, str(tmp_path / "next.pt2"), batch_size=BS,
                             compute_dtype=torch.float32, device="cpu")
    build = lambda: texport.ArtifactService(served, device="cpu")  # noqa: E731
    d = Daemon(tserve.make_http_server, build())
    try:
        code, _, body = d.request("/healthz")
        assert code == 200 and b'"truncation": 0.0' in body
        code, ctype, before = d.request("/generate", {"n": 6, "seed": 4, "format": "npy"})
        assert code == 200 and ctype == "application/octet-stream"
        code, _, body = d.request("/interpolate", {"seed_a": 1, "seed_b": 2})
        assert code == 400 and b"no interpolation path" in body
        watcher = tserve.CheckpointWatcher(d.srv, served, build)
        for suffix in ("", ".json"):
            shutil.copy(str(tmp_path / "next.pt2") + suffix, served + suffix + ".tmp")
            os.replace(served + suffix + ".tmp", served + suffix)
        os.utime(served, ns=(10**9, 10**9))
        assert watcher.poll_once() is True
        after = d.request("/generate", {"n": 6, "seed": 4, "format": "npy"})[2]
        assert after != before
        assert after == d.request("/generate", {"n": 6, "seed": 4, "format": "npy"})[2]
    finally:
        d.close()
