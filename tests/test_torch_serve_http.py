"""The port's HTTP daemon and ``--watch`` hot swap (jckx_torch/serve.py:
``make_http_server``, ``CheckpointWatcher``, the CLI's ``--listen``) on the
CPU, against jckx's daemon (``jckx/serve.py:446-743``) serving the same
reference ``.pt`` at the tiny geometry (16², base width 8, z 16, batch 4,
f32).

The same requests must get the same status codes, content types and JSON
keys from both daemons. Their random draws differ by design, so an npy body
of the port is held against jckx's generator on the port's own z (rebuilt
from the port's request generator): within 1 LSB and at least 99 %
exactly equal. Every server binds ``127.0.0.1:0``, every request has a
timeout, and every server is shut down in ``finally``.
"""

import io
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jckx import serve as jserve
from jckx.models import cgan as jcgan
from jckx.models import dcgan as jdcgan
from jckx_torch import serve as tserve
from test_torch_serve import GEO, _ckpt, _port_checkpoint, _u8_close

TIMEOUT = 60
# the port's /metrics counters that jckx's daemon has not: the latency's parts
LATENCY_PARTS = ("jckx_generate_lock_wait_seconds_sum", "jckx_generate_sample_seconds_sum",
                 "jckx_generate_encode_seconds_sum")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Daemon:
    """A service behind an HTTP front on an ephemeral port of 127.0.0.1.
    It keeps the number of counted requests it has had answered (POSTs to
    /generate and /interpolate) for ``metrics``."""

    COUNTED = ("/generate", "/interpolate")

    def __init__(self, make_http_server, svc):
        self.svc = svc
        self.srv = make_http_server(svc, "127.0.0.1", 0)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        self.answered = 0
        self._lock = threading.Lock()

    def request(self, path, body=None, raw=None):
        url = f"http://127.0.0.1:{self.port}{path}"
        data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
        req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                reply = r.status, r.headers.get("Content-Type"), r.read()
        except urllib.error.HTTPError as e:
            reply = e.code, e.headers.get("Content-Type"), e.read()
        if data is not None and path in self.COUNTED:
            with self._lock:
                self.answered += 1
        return reply

    def metrics(self, wait=10.0):
        """The /metrics counters, read once ``jckx_generate_requests_total``
        has reached the requests already answered, or after ``wait``
        seconds: jckx's daemon counts a request after writing its reply, so
        a read right after the reply can come before the count. The port's
        counts before it replies: its own tests read with ``wait=0``."""
        deadline = time.monotonic() + wait
        while True:
            _, _, body = self.request("/metrics")
            m = dict(line.split() for line in body.decode().splitlines()
                     if line and not line.startswith("#"))
            if int(m["jckx_generate_requests_total"]) >= self.answered \
                    or time.monotonic() > deadline:
                return m
            time.sleep(0.01)

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)


def _png_size(body):
    assert body[:8] == b"\x89PNG\r\n\x1a\n" and body[12:16] == b"IHDR"
    return struct.unpack(">II", body[16:24])


def _shape_of(code, ctype, body):
    """What must agree between the two daemons for one reply."""
    if ctype == "application/json":
        return code, ctype, sorted(json.loads(body))
    if ctype == "image/png":
        return code, ctype, _png_size(body)
    if ctype == "application/octet-stream":
        return code, ctype, np.load(io.BytesIO(body)).shape
    return code, ctype


def _port_z(seed, n, bs=4):
    """The z rows the port's service draws for a request with ``seed``."""
    gen = torch.Generator().manual_seed(tserve._request_seed(seed, 0))
    zs = [torch.randn((bs, GEO.z_dim), generator=gen) for _ in range(-(-n // bs))]
    return zs


@pytest.fixture
def pair(tmp_path):
    """jckx's daemon and the port's on one reference DCGAN .pt."""
    state, path = _ckpt(tmp_path)
    daemons = [Daemon(jserve.make_http_server,
                      jserve.GeneratorService(path, batch_size=4, compute_dtype=jnp.float32)),
               Daemon(tserve.make_http_server,
                      tserve.GeneratorService(path, batch_size=4, compute_dtype=torch.float32,
                                              device="cpu"))]
    try:
        yield state, daemons
    finally:
        for d in daemons:
            d.close()


REQUESTS = [
    ("/healthz", None, None), ("/metrics", None, None), ("/nope", None, None),
    ("/generate", {"n": 6}, None), ("/generate", {"n": 6, "seed": 7, "format": "npy"}, None),
    ("/generate", {}, None),
    *[("/generate", bad, None) for bad in (
        {"n": 0}, {"n": "x"}, {"n": True}, {"n": 4097}, {"labels": [1]}, {"format": "jpeg"},
        {"seed": "x"}, {"seed": True})],
    ("/generate", None, b"not json"), ("/generate", None, b"[1, 2]"), ("/nope", {}, None),
    ("/interpolate", {"seed_a": 1, "seed_b": 2, "steps": 4, "format": "npy"}, None),
    ("/interpolate", {"seed_a": 1, "seed_b": 2}, None),
    *[("/interpolate", bad, None) for bad in (
        {"seed_a": 1}, {"seed_a": 1, "seed_b": 2, "steps": 1}, {"seed_a": 1, "seed_b": 2, "steps": 65},
        {"seed_a": 1, "seed_b": 2, "kind": "x"}, {"seed_a": 1, "seed_b": 2, "label_a": 0},
        {"seed_a": True, "seed_b": 2}, {"seed_a": 1, "seed_b": 2, "format": "gif"})],
]


def test_http_contract_matches_jckx(pair):
    state, (jd, td) = pair
    replies = {}
    for path, body, raw in REQUESTS:
        got = [d.request(path, body, raw) for d in (jd, td)]
        want, mine = (_shape_of(*r) for r in got)
        assert mine == want, (path, body, raw)
        replies[(path, json.dumps(body), raw)] = got[1]
    jh = json.loads(jd.request("/healthz")[2])
    th = json.loads(td.request("/healthz")[2])
    assert th == jh  # same step, geometry, batch and truncation from the same file
    jm, tm = jd.metrics(), td.metrics()
    assert set(tm) == set(jm) | set(LATENCY_PARTS)  # the port splits the latency too
    for k in ("jckx_generate_requests_total", "jckx_generate_images_total",
              "jckx_generate_errors_total", "jckx_checkpoint_step", "jckx_serving_batch_size"):
        assert tm[k] == jm[k], k
    assert float(tm["jckx_generate_seconds_sum"]) > 0.0

    # the port's npy bodies against jckx's generator on the port's own z
    _, _, body = replies[("/generate", json.dumps({"n": 6, "seed": 7, "format": "npy"}), None)]
    ref = np.concatenate([np.asarray(jserve.tanh_to_u8(jdcgan.generator_apply(
        state.params_g, jnp.asarray(z.numpy()), GEO, jnp.float32))) for z in _port_z(7, 6)])[:6]
    _u8_close(np.load(io.BytesIO(body)), ref)
    _, _, body = replies[("/interpolate", json.dumps({"seed_a": 1, "seed_b": 2, "steps": 4,
                                                      "format": "npy"}), None)]
    svc = td.svc
    z = tserve.interpolation_latents(svc.endpoint_z(1), svc.endpoint_z(2), torch.linspace(0, 1, 4))
    ref = jserve.tanh_to_u8(jdcgan.generator_apply(state.params_g, jnp.asarray(z.numpy()), GEO,
                                                   jnp.float32))
    _u8_close(np.load(io.BytesIO(body)), ref)
    # a seed makes a request byte-deterministic; a new seed changes it
    a = td.request("/generate", {"n": 6, "seed": 7, "format": "npy"})[2]
    assert a == td.request("/generate", {"n": 6, "seed": 7, "format": "npy"})[2]
    assert a != td.request("/generate", {"n": 6, "seed": 8, "format": "npy"})[2]


def test_http_cgan_labels_match_jckx(tmp_path):
    state, path = _ckpt(tmp_path, conditional=True)
    jd = Daemon(jserve.make_http_server,
                jserve.GeneratorService(path, batch_size=4, compute_dtype=jnp.float32))
    td = Daemon(tserve.make_http_server,
                tserve.GeneratorService(path, batch_size=4, compute_dtype=torch.float32,
                                        device="cpu"))
    try:
        reqs = [("/generate", {"n": 6, "labels": [0, 3], "seed": 2, "format": "npy"}),
                ("/generate", {"n": 2, "labels": [10]}), ("/generate", {"n": 2, "labels": []}),
                ("/generate", {"n": 2, "labels": "3"}), ("/generate", {"n": 3}),
                ("/interpolate", {"seed_a": 1, "seed_b": 2, "steps": 3, "label_a": 1,
                                  "label_b": 4, "format": "npy"}),
                ("/interpolate", {"seed_a": 1, "seed_b": 2}),
                ("/interpolate", {"seed_a": 1, "seed_b": 2, "label_a": 10}),
                ("/interpolate", {"seed_a": 1, "seed_b": 2, "label_a": "x"})]
        for p, body in reqs:
            want, mine = (_shape_of(*d.request(p, body)) for d in (jd, td))
            assert mine == want, body
        _, _, body = td.request(*reqs[0])
        labels = np.asarray([[0, 3][i % 2] for i in range(8)])
        ref = np.concatenate([np.asarray(jserve.tanh_to_u8(jcgan.cgenerator_apply(
            state.params_g, jnp.asarray(z.numpy()),
            jnp.asarray(np.eye(10, dtype=np.float32)[labels[4 * i:4 * i + 4]]), GEO, jnp.float32)))
            for i, z in enumerate(_port_z(2, 6))])[:6]
        _u8_close(np.load(io.BytesIO(body)), ref)
        assert json.loads(td.request("/healthz")[2])["conditional"] is True
    finally:
        jd.close()
        td.close()


def _watched(tmp_path):
    path = str(tmp_path / "latest.ckpt")
    _port_checkpoint(path, step=1, seed=0)
    os.utime(path, ns=(10**9, 10**9))

    def build():
        return tserve.GeneratorService(path, batch_size=4, compute_dtype=torch.float32,
                                       device="cpu")

    d = Daemon(tserve.make_http_server, build())
    return path, d, tserve.CheckpointWatcher(d.srv, path, build)


def _replace(path, step, seed):
    """Atomically replace the checkpoint, as the trainer does."""
    _port_checkpoint(path + ".tmp", step=step, seed=seed)
    os.replace(path + ".tmp", path)
    os.utime(path, ns=(step * 10**9, step * 10**9))


def test_watch_hot_swaps_and_keeps_serving_across_a_failed_reload(tmp_path):
    path, d, watcher = _watched(tmp_path)
    npy = {"n": 2, "seed": 9, "format": "npy"}
    try:
        assert watcher.poll_once() is False  # no change, no swap
        assert json.loads(d.request("/healthz")[2])["step"] == 1
        a = d.request("/generate", npy)[2]
        with open(path, "wb") as f:  # a torn write must not take the daemon down
            f.write(b"torn write")
        os.utime(path, ns=(5 * 10**9, 5 * 10**9))
        assert watcher.poll_once() is False and watcher.poll_once() is False
        assert json.loads(d.request("/healthz")[2])["step"] == 1
        assert d.request("/generate", npy)[2] == a
        _replace(path, step=2, seed=7)  # the retry succeeds
        assert watcher.poll_once() is True
        assert json.loads(d.request("/healthz")[2])["step"] == 2
        b = d.request("/generate", npy)[2]
        assert b != a
        fresh = tserve.GeneratorService(path, batch_size=4, compute_dtype=torch.float32,
                                        device="cpu")
        np.testing.assert_array_equal(np.load(io.BytesIO(b)), fresh.sample(2, seed=9))
        assert watcher.poll_once() is False
    finally:
        d.close()


def test_http_concurrent_clients_during_hot_swap(tmp_path):
    """Clients on handler threads while the watcher swaps under them: no
    5xx, valid payloads, exact counters, determinism after the last swap."""
    path, d, watcher = _watched(tmp_path)
    try:
        assert d.request("/generate", {"n": 2})[0] == 200
        jobs = [{"n": 2, "seed": i % 5, "format": "npy"} if i % 3 else {"n": 2} for i in range(24)]
        jobs += [{"n": 0}] * 6
        with ThreadPoolExecutor(8) as ex:
            futs = [ex.submit(d.request, "/generate", j) for j in jobs]
            for step, seed in ((2, 7), (3, 9)):
                _replace(path, step, seed)
                assert watcher.poll_once() is True
            results = [f.result() for f in futs]
        for job, (code, ctype, body) in zip(jobs, results):
            if job["n"] == 0:
                assert code == 400 and "error" in json.loads(body)
            elif job.get("format") == "npy":
                assert code == 200 and np.load(io.BytesIO(body)).shape == (2, 16, 16, 3)
            else:
                assert code == 200 and _png_size(body)[0] > 0
        m = d.metrics(wait=0)
        assert m["jckx_generate_requests_total"] == str(1 + len(jobs))
        assert m["jckx_generate_images_total"] == str(2 + 24 * 2)
        assert m["jckx_generate_errors_total"] == "6"
        assert m["jckx_checkpoint_step"] == "3"
        npy = {"n": 2, "seed": 9, "format": "npy"}
        assert d.request("/generate", npy)[2] == d.request("/generate", npy)[2]
    finally:
        d.close()


def test_http_render_failure_is_a_json_500(tmp_path):
    _, path = _ckpt(tmp_path)
    svc = tserve.GeneratorService(path, batch_size=4, compute_dtype=torch.float32, device="cpu")
    d = Daemon(tserve.make_http_server, svc)

    def boom(*a, **k):
        raise RuntimeError("card fell over")

    try:
        svc.sample = boom
        svc.interpolate = boom
        for p, body in (("/generate", {"n": 2}), ("/interpolate", {"seed_a": 1, "seed_b": 2})):
            code, ctype, reply = d.request(p, body)
            assert code == 500 and "card fell over" in json.loads(reply)["error"]
        assert d.metrics(wait=0)["jckx_generate_errors_total"] == "2"
    finally:
        d.close()


class _SlowService:
    """A service whose every sample takes 0.3 s."""

    step, batch_size, conditional, num_classes = 0, 4, False, 0

    def sample(self, n, labels=None, seed=None):
        time.sleep(0.3)
        return np.zeros((n, 16, 16, 3), np.uint8)


def test_http_metrics_split_the_latency_and_show_the_lock_wait():
    """The latency's parts in /metrics: present and 0 at start; two
    concurrent /generate against a 0.3 s sample, so one waits for the lock."""
    d = Daemon(tserve.make_http_server, _SlowService())
    try:
        m = d.metrics(wait=0)
        assert [m[k] for k in LATENCY_PARTS] == ["0.0"] * 3
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(d.request, "/generate", {"n": 2, "format": "npy"}) for _ in range(2)]
            assert [f.result()[0] for f in futs] == [200, 200]
        m = d.metrics(wait=0)
        wait, sample, encode = (float(m[k]) for k in LATENCY_PARTS)
        assert wait >= 0.15 and sample >= 0.6 and encode >= 0
        assert float(m["jckx_generate_seconds_sum"]) >= wait + sample
    finally:
        d.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_daemon_watches_and_stops_on_sigterm(tmp_path):
    """``python -m jckx_torch.serve --listen --watch`` on the CPU: it answers
    /healthz, follows the replaced checkpoint, and exits 0 on SIGTERM."""
    path = str(tmp_path / "latest.ckpt")
    _port_checkpoint(path, step=1, seed=0)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jckx_torch.serve", "--ckpt", path, "--listen", f"127.0.0.1:{port}",
         "--watch", "0.2", "--batch_size", "4", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def healthz():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
            return json.loads(r.read())

    def wait_for(cond, what):
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.communicate()[0]
            try:
                if cond():
                    return
            except OSError:
                pass
            time.sleep(0.1)
        raise AssertionError(f"timed out waiting for {what}")

    try:
        wait_for(lambda: healthz()["step"] == 1, "the daemon")
        _replace(path, step=4, seed=3)
        wait_for(lambda: healthz()["step"] == 4, "the hot swap")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, out
        assert "serving step-1 checkpoint" in out and "now serving step-4" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
