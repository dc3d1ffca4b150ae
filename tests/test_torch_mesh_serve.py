"""Serving over a local mesh (``GeneratorService(mesh=...)``, ``serve
--mesh_shape N``; jckx/serve.py:328-356) on the CPU: a mesh of ``[cpu,
cpu]`` splits every request batch over two worker threads, each rendering
its rows with the BN statistics summed over both.

- Against the unsharded service on the same request (same z, same labels):
  within 1 LSB and at least 99 % of the pixels exactly equal, for DCGAN and
  CGAN with labels, f32 and bf16 (``floor`` sends two f32 values a rounding
  error apart to neighbouring levels, and the statistics' sums reassociate);
  the int8 sampler within 4 LSB on at least 97.5 % (a one-ulp difference at
  a quantization boundary flips an int8 activation: chip_smoke.py's rule).
- Against jckx's service with ``mesh=make_mesh((2,))`` on the same weights
  and jckx's z: within 1 LSB.
- ``/interpolate`` renders unsharded (equal to the unsharded service's);
  the daemon's ``/generate`` goes through the mesh; the CLI serves with
  ``--mesh_shape 2`` and refuses a 2-D mesh, an indivisible batch and a
  ``.pt2`` with a mesh.
"""

import io
import json
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx import serve as jserve
from jckx.parallel import make_mesh as jmake_mesh
from jckx_torch import serve as tserve
from jckx_torch.parallel import make_mesh
from test_torch_serve import GEO, _ckpt
from torch_threads import one_torch_thread  # noqa: F401

BS = 8


def _pair(path, **kw):
    one = tserve.GeneratorService(path, batch_size=BS, device="cpu", **kw)
    mesh = make_mesh((2,), devices=["cpu", "cpu"])
    two = tserve.GeneratorService(path, batch_size=BS, mesh=mesh, **kw)
    return one, two


def _agree(a, b, max_lsb=1, min_exact=0.99):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= max_lsb and (diff == 0).mean() >= min_exact, \
        (diff.max(), (diff == 0).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conditional", [False, True])
def test_sharded_render_matches_the_unsharded_service(tmp_path, dtype, conditional):
    _, path = _ckpt(tmp_path, conditional=conditional)
    one, two = _pair(path, compute_dtype=getattr(torch, dtype))
    assert two.mesh.size == 2 and two.device == torch.device("cpu")
    labels = [3, 1, 4] if conditional else None
    _agree(one.sample(20, labels=labels, seed=7), two.sample(20, labels=labels, seed=7))
    if conditional:  # random classes, drawn after each batch's z on the first device
        _agree(one.sample(8, seed=2), two.sample(8, seed=2))


def test_sharded_int8_sampler_matches_the_unsharded_one(tmp_path):
    _, path = _ckpt(tmp_path, conditional=True)
    one, two = _pair(path, compute_dtype=torch.float32, quant="int8", seed=3)
    _agree(one.sample(16, labels=[2, 5], seed=1), two.sample(16, labels=[2, 5], seed=1),
           max_lsb=4, min_exact=0.975)


@pytest.mark.parametrize("conditional", [False, True])
def test_sharded_render_matches_jckx_on_a_two_device_mesh(tmp_path, conditional):
    _, path = _ckpt(tmp_path, conditional=conditional)
    jsvc = jserve.GeneratorService(path, batch_size=BS, compute_dtype=jnp.float32,
                                   mesh=jmake_mesh((2,)))
    _, two = _pair(path, compute_dtype=torch.float32)
    labels = [7, 0, 2] if conditional else None
    ref = jsvc.sample(BS, labels=labels, key=5)
    # jckx's z of that request: normal(fold_in(PRNGKey(5), 0)), on the host
    z = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(5), 0),
                                     (BS, GEO.z_dim)))
    lab = None if labels is None else torch.tensor([labels[i % 3] for i in range(BS)])
    got = two.render(torch.from_numpy(z), lab).numpy()
    _agree(got, ref, min_exact=0.0)


def test_interpolation_renders_unsharded(tmp_path):
    _, path = _ckpt(tmp_path, conditional=True)
    one, two = _pair(path, compute_dtype=torch.float32)
    calls = []
    run = two.mesh.run
    two.mesh.run = lambda fn: calls.append(fn) or run(fn)
    np.testing.assert_array_equal(one.interpolate(1, 2, steps=5, label_a=3, label_b=4),
                                  two.interpolate(1, 2, steps=5, label_a=3, label_b=4))
    assert calls == []
    two.sample(4, labels=[1], seed=0)
    assert len(calls) == 1


def test_daemon_generates_through_the_mesh(tmp_path):
    import threading

    _, path = _ckpt(tmp_path)
    one, two = _pair(path, compute_dtype=torch.float32)
    threads = set()
    run = two.mesh.run

    def counted(fn):
        def member(i, dev):
            threads.add(threading.current_thread().name)
            return fn(i, dev)
        return run(member)

    two.mesh.run = counted
    srv = tserve.make_http_server(two, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/generate",
                                     data=json.dumps({"n": 12, "seed": 4, "format": "npy"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = np.load(io.BytesIO(r.read()))
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert threads == {"jckx-mesh-0", "jckx-mesh-1"}
    np.testing.assert_array_equal(body, two.sample(12, seed=4))
    _agree(body, one.sample(12, seed=4))


def test_cli_serves_over_a_mesh_and_refuses(tmp_path, capsys):
    _, path = _ckpt(tmp_path)
    out = str(tmp_path / "g.png")
    common = ["--ckpt", path, "--device", "cpu", "-o", out]
    tserve.main(tserve.get_args(common + ["--mesh_shape", "2", "--batch_size", "8", "-n", "10"]))
    assert "wrote 10 samples" in capsys.readouterr().out
    tserve.main(tserve.get_args(common + ["--mesh_shape", "2", "--batch_size", "8",
                                          "--interpolate", "1,2", "--steps", "3"]))
    assert "3-frame slerp walk" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="1-D"):
        tserve.main(tserve.get_args(common + ["--mesh_shape", "2,2"]))
    with pytest.raises(ValueError, match=r"batch_size 8 is not divisible by the mesh 'data' "
                                         r"axis \(3 shards\)"):
        tserve.main(tserve.get_args(common + ["--mesh_shape", "3", "--batch_size", "8"]))
    with pytest.raises(SystemExit, match="mesh"):
        tserve.main(tserve.get_args(["--ckpt", str(tmp_path / "g.pt2"), "--device", "cpu",
                                     "--mesh_shape", "2"]))
    with pytest.raises(ValueError, match="first device"):
        tserve.GeneratorService(path, batch_size=8, device="meta",
                                mesh=make_mesh((2,), devices=["cpu", "cpu"]))
