"""Serving: load a DCGAN or CGAN generator checkpoint and generate images —
port of ``jckx/serve.py``.

    python -m jckx_torch.serve --ckpt save/dcgan/<ts>/latest.ckpt -n 64 -o samples.png \
        [--labels 3,17,42] [--truncation 0.7] [--quant int8] [--subpixel 1] [--device cpu]
    python -m jckx_torch.serve --ckpt model.pt --interpolate 1,2 --steps 10 -o walk.png
    python -m jckx_torch.serve --ckpt save/dcgan/<ts>/latest.ckpt --listen 8000 --watch 30

``GeneratorService`` reads the port's ``latest.ckpt`` and best ``.pt``
files, the reference's ``.pt`` and jckx's ``.ckpt`` (``checkpoint.
load_generator``: the EMA generator by default where the file holds one),
runs on the card unless
``device`` names another, and renders every batch through the
hand-written fused BN + ReLU kernel (``kernels/csrc/fused_bn_act.cu``):
four launches per generator forward, in bf16 for the float and sub-pixel
samplers and f32 for the int8 one (``ops/quant.py``).

Each request draws z on the device from a ``torch.Generator`` seeded by
(seed, request counter) — N(0, 1), or N(0, 1) truncated to [-t, t] with
``truncation`` — renders, converts tanh output to uint8 on the device, and
copies only the uint8 payload to the host, each batch straight into its
rows of the request's one reply (``pipelined_sample``: on the card a
page-locked reply of up to ``PINNED_REPLY_BYTES``, filled on the device's
copy stream under the later renders). Every batch renders the full
batch size and is trimmed afterwards: under batch-statistic BN the batch is
part of the function. A CGAN request with ``labels`` gives row ``i`` the
class ``labels[i % len(labels)]`` (``jckx/serve.py:383-387``); without
them each batch draws random classes after its z (``:292-293``).

On the card each batch's render is one replay of a CUDA graph
(``utils/graphs.GraphedProgram``, as jckx jits ``render_rand`` /
``render_labeled``, ``jckx/serve.py:343-352``): G's forward with its four
kernel launches and ``tanh_to_u8``, captured after the service's first
batch renders eagerly. The draws (z, and CGAN's random classes) stay
outside the graph, eager, from the request's generator in the same order:
a capture would freeze the generator's offset, and with the draws outside
the graph reads the same z and labels as the eager route, so its images
are the same bits. Each replay returns a copy of the graph's output, so
the window of undrained batches never aliases a later replay. The render
stays eager on the CPU and over a local mesh (``graph_for``);
``program = None`` forces the eager route.

``interpolate`` renders a latent walk between the z of two seeds (slerp or
lerp, ``interpolation_latents``) as one batch. ``make_http_server`` is the
stdlib HTTP daemon (``GET /healthz``, ``GET /metrics``, ``POST /generate``,
``POST /interpolate``), and ``CheckpointWatcher`` its ``--watch`` hot swap.

``--ckpt gen.pt2`` serves a sealed ``torch.export`` artifact
(``export.ArtifactService``, ``jckx/serve.py:847-862``): its geometry,
batch, dtype and sampler were fixed at export, so the flags that would
change them are refused, and the daemon answers ``/interpolate`` with a
400. ``--watch`` reloads a replaced artifact like a checkpoint.

``--mesh_shape N`` (``GeneratorService(mesh=...)``; ``jckx/serve.py:125``,
``:328-356``, ``:834-846``) serves from one process over a local mesh of N
devices, ``cuda:0`` … ``cuda:N-1``: G is replicated on each device, and
each renders its batch/N rows of every request batch, one worker thread
per device, with the BN statistics summed over the devices in device order
before each device's kernel normalizes its own rows (4 launches per
device per batch). z is drawn on the first device, as unsharded, so a
sharded render equals the unsharded one up to the reassociation of the
statistics. ``/interpolate`` renders unsharded, as jckx does (a walk is a
one-shot of at most 4096 rows); the daemon and ``--watch`` serve through
the sharded service unchanged. Refused: a 2-D shape, a batch the mesh does
not divide, and a mesh with a ``.pt2`` artifact.

Refused by name: jckx's StableHLO ``.jaxexp`` artifacts, which need JAX
(``python -m jckx.serve``).

A BigGAN checkpoint (``models/biggan.py``, recognized by its weights) is
served as a CGAN is: the float sampler in the compute dtype, one graph
replay a batch, the same drains; its z is 120 wide (``draw_z``, truncation
included) and its class count the embedding's. Its batch takes ten
conditional BN kernel launches and one per-channel one. The int8 sampler
and the sub-pixel form (``make_sampler``), a local mesh and a ``.pt2``
export raise a ``ValueError`` that names BigGAN: each reads the
generator's ``forms`` (``models/dcgan.require_form``), and BigGAN's is the
float form alone.
"""

from __future__ import annotations

import argparse
import collections
import copy
import functools
import hashlib
import io
import json
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from jckx_torch.checkpoint.checkpoint import GEOMETRY_FIELDS, load_generator
from jckx_torch.data.pipeline import one_hot
from jckx_torch.logging.artifacts import encode_png, make_grid, save_image_grid
from jckx_torch.models.dcgan import require_form
from jckx_torch.ops.quant import make_sampler
from jckx_torch.parallel.mesh import DATA_AXIS, make_mesh, parse_mesh_shape
from jckx_torch.utils import spans
from jckx_torch.utils.device import resolve_device
from jckx_torch.utils.graphs import GraphedProgram, graph_for

# undrained batches a request may hold on the device (6 MiB each at 64², bs512)
WINDOW = 8
# the largest reply kept in page-locked memory: the daemon's cap, 4096
# images at 64² RGB, is 48 MiB; a bulk request of 2048 BigGAN images at 128²
# RGB is 96 MiB
PINNED_REPLY_BYTES = 128 << 20
# requests by their reply's memory (the daemon samples from handler threads)
REPLIES = {"pinned": 0, "pageable": 0}
_REPLIES_LOCK = threading.Lock()
JAXEXP_REFUSAL = ("a jckx .jaxexp artifact is a StableHLO program and needs JAX: serve it with "
                  "`python -m jckx.serve`, or export the checkpoint with `python -m jckx_torch "
                  "export` and serve the .pt2")


def validate_sample_args(n: int, labels, conditional: bool):
    """Request validation → normalized labels (empty selection means
    random classes)."""
    if n < 1:
        raise ValueError(f"sample(n={n}): n must be >= 1")
    # len(), not truthiness: a numpy label array raises on bool()
    if labels is not None and len(labels) == 0:
        labels = None
    if labels is not None and not conditional:
        # silently returning random unconditional samples would let the
        # caller believe class control worked
        raise ValueError(
            "labels were given but this checkpoint is unconditional "
            "(DCGAN) — class-conditional sampling needs a CGAN checkpoint")
    return labels


def tanh_to_u8(imgs: torch.Tensor) -> torch.Tensor:
    """tanh output in [-1, 1] → uint8 on the tensor's device. floor (not
    round), as jckx's ``tanh_to_u8`` and numpy's ``astype(uint8)``."""
    x = imgs.float() * 0.5 + 0.5
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def pipelined_sample(n: int, bs: int, render) -> np.ndarray:
    """Render ``ceil(n / bs)`` full batches (``render(made)`` → a uint8
    batch (bs, S, S, C), ``made`` the rows of the request before it), trim
    the last, and land each batch's rows in order in one reply (n, S, S, C),
    allocated once, on the first batch. → ``reply.numpy()``, which keeps the
    reply's memory alive while the caller holds it.

    Where the batches are CUDA tensors and the reply is at most
    ``PINNED_REPLY_BYTES``, the reply is page-locked memory from torch's
    caching host allocator, and each batch's copy is issued right after its
    render, asynchronously on the device's copy stream, so copy k runs
    under render k + 1; an event a batch says when its rows have landed.
    The block goes back to torch's host cache when the caller drops the
    array, so a caller that keeps many replies holds that much locked host
    memory. A larger reply (the CLI's big ``-n``), or one of CPU batches,
    is pageable, and each batch is copied into its rows synchronously, one
    ``WINDOW`` of batches behind the renders. Either way at most ``WINDOW``
    batches wait on the device for their copy: the host waits for the
    oldest before it renders another. ``REPLIES`` counts the requests by
    their reply's memory.

    Under a profiler the request is the span ``serve.sample``, its batches'
    ``serve.render`` (the host's part: draws, input copies, the replay's
    enqueue) and ``serve.drain`` (issuing the batch's copy, and any wait
    the window forces), and ``serve.assemble`` (the wait until the reply is
    whole)."""
    reply, made = None, 0
    pending = collections.deque()  # per batch not landed: the call that lands it

    with spans.span("serve.sample", n):
        while made < n:
            with spans.span("serve.render", 1):
                imgs = render(made)
            take = min(bs, n - made)
            with spans.span("serve.drain", 1):
                if reply is None:
                    reply, pinned = _new_reply(n, imgs)
                rows = reply[made:made + take]
                if pinned:
                    stream = _copy_stream(imgs.device)
                    stream.wait_stream(torch.cuda.current_stream(imgs.device))
                    with torch.cuda.stream(stream):
                        rows.copy_(imgs[:take], non_blocking=True)
                    imgs.record_stream(stream)  # its memory waits for the copy
                    pending.append(stream.record_event().synchronize)
                else:
                    pending.append(functools.partial(rows.copy_, imgs[:take]))
                made += take
                if len(pending) == WINDOW and made < n:  # the window is full; a render follows
                    pending.popleft()()
        with spans.span("serve.assemble", n):
            while pending:
                pending.popleft()()
    return reply.numpy()


def _new_reply(n: int, imgs: torch.Tensor):
    """The empty reply of an ``n``-row request whose first batch is
    ``imgs``, counted in ``REPLIES``. → (the reply, whether it is
    page-locked: where the batch is on the card and the reply fits
    ``PINNED_REPLY_BYTES``)."""
    shape = (n, *imgs.shape[1:])
    nbytes = n * imgs[0].numel() * imgs.element_size()
    pinned = imgs.is_cuda and nbytes <= PINNED_REPLY_BYTES
    with _REPLIES_LOCK:
        REPLIES["pinned" if pinned else "pageable"] += 1
    return torch.empty(shape, dtype=imgs.dtype, pin_memory=pinned), pinned


@functools.lru_cache(maxsize=None)
def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream a CUDA ``device``'s replies are copied on, one for every
    service on it: each copy first waits for the requesting thread's stream
    and records its own event, so concurrent requests (a hot swap's old and
    new service) stay correct and only queue their copies."""
    return torch.cuda.Stream(device)


def render_u8(apply, params, z: torch.Tensor, onehot: Optional[torch.Tensor]) -> torch.Tensor:
    """One forward of a sampler (``make_sampler``'s ``apply`` on its
    params) → uint8 images: the work of one served batch."""
    return tanh_to_u8(apply(params, z, onehot))


def _request_seed(seed: int, count: int) -> int:
    """A 63-bit generator seed from (seed, request counter)."""
    digest = hashlib.sha256(f"{seed}:{count}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def interpolation_latents(za: torch.Tensor, zb: torch.Tensor, t: torch.Tensor,
                          kind: str = "slerp") -> torch.Tensor:
    """The latent walk from ``za`` to ``zb`` (each (z_dim,)) at the points
    ``t`` (steps,) → (steps, z_dim): slerp (the geodesic for Gaussian
    latents) or lerp (``jckx/serve.py:308-323``). Where za ∥ zb slerp's sin
    ratio is 0/0, and it falls back to lerp."""
    tt = t[:, None]
    if kind == "slerp":
        na, nb = za / torch.linalg.norm(za), zb / torch.linalg.norm(zb)
        omega = torch.arccos(torch.clamp(torch.dot(na, nb), -1.0, 1.0))
        so = torch.sin(omega)
        safe = so > 1e-6
        denom = torch.where(safe, so, torch.ones_like(so))
        wa = torch.where(safe, torch.sin((1.0 - tt) * omega) / denom, 1.0 - tt)
        wb = torch.where(safe, torch.sin(tt * omega) / denom, tt)
    elif kind == "lerp":
        wa, wb = 1.0 - tt, tt
    else:
        raise ValueError(f"kind {kind!r} must be 'slerp' or 'lerp'")
    return wa * za[None, :] + wb * zb[None, :]


class GeneratorService:
    """Checkpoint-backed DCGAN or CGAN image generator. The family, the
    geometry and the class count come from the weights; ``conditional``,
    ``num_classes`` and ``geo_overrides`` (geometry fields) are jckx's
    explicit overrides and raise where they contradict them. ``quant="int8"``
    serves the W8A8 sampler calibrated from ``seed``; ``subpixel`` the
    sub-pixel ConvTranspose; ``truncation`` t > 0 draws z from N(0, 1)
    truncated to [-t, t]. ``mesh``, a ``LocalMesh``, splits every request
    batch over its devices (its first device is the service's; ``device``
    must then be left unset or name it)."""

    def __init__(
        self,
        ckpt_path: str,
        conditional: Optional[bool] = None,
        num_classes: Optional[int] = None,
        batch_size: int = 512,
        compute_dtype=torch.bfloat16,
        seed: int = 0,
        use_ema: Optional[bool] = None,
        geo_overrides: Optional[dict] = None,
        subpixel: bool = False,
        quant: Optional[str] = None,
        truncation: float = 0.0,
        device=None,
        mesh=None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size {batch_size} must be >= 1")
        if truncation < 0:
            raise ValueError(f"truncation {truncation} must be >= 0 (0 = off)")
        if quant not in (None, "int8"):
            raise ValueError(f"quant={quant!r}: supported modes are None (float) and 'int8'")
        if ckpt_path.endswith(".jaxexp"):
            raise ValueError(f"{ckpt_path}: {JAXEXP_REFUSAL}")
        if ckpt_path.endswith(".pt2"):
            raise ValueError(f"{ckpt_path} is a sealed artifact: serve it through "
                             f"export.ArtifactService")
        if mesh is not None:
            if batch_size % mesh.size:
                raise ValueError(f"serving batch_size {batch_size} is not divisible by the mesh "
                                 f"'data' axis ({mesh.size} shards)")
            if device is not None and torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first device "
                                 f"{mesh.devices[0]}")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        loaded = load_generator(ckpt_path, use_ema=use_ema, conditional=conditional,
                                num_classes=num_classes, geo_overrides=geo_overrides)
        if mesh is not None:
            require_form(loaded.G, "mesh")
        self.conditional, self.geo, self.num_classes = loaded.conditional, loaded.geo, loaded.num_classes
        self.step, self.used_ema = loaded.step, loaded.used_ema
        self.G = loaded.G.to(self.device)
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.quant, self.subpixel, self.truncation = quant, bool(subpixel), float(truncation)
        self._count = 0
        # the float G itself, or the int8 params calibrated from the seed
        self.params, self.sampler_apply = make_sampler(
            self.G, quant=quant, compute_dtype=compute_dtype, seed=seed, subpixel=self.subpixel)
        # the params replicated on each device of the mesh (one copy per distinct device)
        self._replicas = {self.device: self.params}
        for dev in (mesh.devices if mesh is not None else []):
            if dev not in self._replicas:
                self._replicas[dev] = (copy.deepcopy(self.params).to(dev) if quant is None else
                                       {k: v.to(dev) for k, v in self.params.items()})
        # one batch's render as a graph (the program holds the sampler, not
        # the service: a dropped service frees its graphs' pools at once)
        graph, _ = graph_for(self.device, mesh=mesh)
        self.program = (GraphedProgram(functools.partial(render_u8, self.sampler_apply, self.params),
                                       self.device, graph) if graph else None)

    def draw_z(self, gen: torch.Generator, shape) -> torch.Tensor:
        """z of the service's law from ``gen``, on the service's device."""
        if self.truncation > 0:
            z = torch.empty(shape, device=self.device)
            return torch.nn.init.trunc_normal_(z, 0.0, 1.0, -self.truncation, self.truncation,
                                               generator=gen)
        return torch.randn(shape, generator=gen, device=self.device)

    def render_latents(self, z: torch.Tensor, onehot: Optional[torch.Tensor] = None,
                       sharded: bool = True) -> torch.Tensor:
        """One forward of the service's sampler on ``z`` (B, z_dim) and, for
        CGAN, float class weights ``onehot`` (B, K) → uint8 (B, S, S, C) on
        the service's device: a replay of ``program`` on the card; over the
        mesh (unless ``sharded`` is false) each device renders its rows."""
        with torch.inference_mode():
            z = z.to(self.device)
            onehot = None if onehot is None else onehot.to(self.device)
            if self.mesh is None or not sharded:
                if self.program is not None:
                    return self.program(z, onehot)
                return render_u8(self.sampler_apply, self.params, z, onehot)
            mesh = self.mesh

            def shard(i: int, dev: torch.device) -> torch.Tensor:
                zi = mesh.rows(z, i).to(dev)
                oi = None if onehot is None else mesh.rows(onehot, i).to(dev)
                return tanh_to_u8(self.sampler_apply(self._replicas[dev], zi, oi, mesh))

            return torch.cat([part.to(self.device) for part in mesh.run(shard)])

    def render(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One generator forward on ``z`` (B, z_dim), and for CGAN the class
        ids ``labels`` (B,) → uint8 (B, S, S, C) on the service's device."""
        if (labels is not None) != self.conditional:
            raise ValueError("render takes class labels for a CGAN checkpoint, and only then")
        onehot = None if labels is None else one_hot(labels.to(self.device), self.num_classes)
        return self.render_latents(z, onehot)

    def sample(self, n: int, labels: Optional[Sequence[int]] = None,
               seed: Optional[int] = None) -> np.ndarray:
        """→ uint8 images (n, S, S, C). ``seed`` makes the request
        deterministic; without it each request draws fresh noise. ``labels``
        (CGAN, BigGAN) cycle over the request's rows; without them each batch
        draws random classes. On the card a reply of up to 128 MiB
        (``PINNED_REPLY_BYTES``) is page-locked memory from torch's host
        cache, returned to it when the caller drops the array: a caller
        that keeps many replies holds that much locked host memory."""
        labels = validate_sample_args(n, labels, self.conditional)
        if labels is not None:
            labels = np.asarray(labels, np.int64)
            if labels.min() < 0 or labels.max() >= self.num_classes:
                raise ValueError(f"labels must lie in [0, {self.num_classes})")
            labels = torch.from_numpy(labels).to(self.device)
        if seed is None:
            self._count += 1
            gseed = _request_seed(self.seed, self._count)
        else:
            gseed = _request_seed(seed, 0)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(gseed)
        bs = self.batch_size
        rows = torch.arange(bs, device=self.device)

        def render(made: int):
            z = self.draw_z(gen, (bs, self.geo.z_dim))
            if not self.conditional:
                return self.render(z)
            if labels is None:
                lab = torch.randint(0, self.num_classes, (bs,), generator=gen, device=self.device)
            else:
                lab = labels[(made + rows) % labels.numel()]
            return self.render(z, lab)

        return pipelined_sample(n, bs, render)

    def endpoint_z(self, seed: int) -> torch.Tensor:
        """The walk's endpoint latent of ``seed``: one z (z_dim,) of the
        service's law from the generator seeded by (seed, 0)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_request_seed(seed, 0))
        return self.draw_z(gen, (self.geo.z_dim,))

    def interpolate(self, seed_a: int, seed_b: int, steps: int = 10,
                    label_a: Optional[int] = None, label_b: Optional[int] = None,
                    kind: str = "slerp") -> np.ndarray:
        """Latent interpolation: → uint8 images (steps, S, S, C), the walk
        from ``endpoint_z(seed_a)`` to ``endpoint_z(seed_b)``, rendered as
        ONE batch (under batch-stat BN the batch is part of the function),
        so a row is a function of (seeds, labels, steps, kind) only. A CGAN
        checkpoint needs ``label_a`` (``label_b`` defaults to it); differing
        labels lerp the class one-hot alongside the latent. The render is
        eager, also on the card: jckx jits it per ``steps``, but a walk is
        a one-shot of at most 4096 rows, and a graph captured for it would
        cost more than it saves."""
        if not 2 <= steps <= 4096:
            raise ValueError(f"steps {steps} must be in [2, 4096]")
        if kind not in ("slerp", "lerp"):
            raise ValueError(f"kind {kind!r} must be 'slerp' or 'lerp'")
        t = torch.linspace(0.0, 1.0, steps, device=self.device)
        onehot = None
        if self.conditional:
            if label_a is None:
                raise ValueError("conditional checkpoint: interpolate needs label_a "
                                 "(label_b defaults to label_a)")
            if label_b is None:
                label_b = label_a
            for lab in (label_a, label_b):
                if not 0 <= lab < self.num_classes:
                    raise ValueError(f"label {lab} out of [0, {self.num_classes})")
            ends = one_hot(torch.tensor([label_a, label_b], device=self.device), self.num_classes)
            onehot = (1.0 - t[:, None]) * ends[0] + t[:, None] * ends[1]
        elif label_a is not None or label_b is not None:
            raise ValueError("labels given but the checkpoint is unconditional")
        z = interpolation_latents(self.endpoint_z(seed_a), self.endpoint_z(seed_b), t, kind)
        with torch.inference_mode():
            return render_u8(self.sampler_apply, self.params, z, onehot).cpu().numpy()


# ----------------------------------------------------------------- HTTP mode

def make_http_server(svc, host: str = "0.0.0.0", port: int = 8000):
    """The HTTP front of a ``GeneratorService`` or an
    ``export.ArtifactService`` (stdlib only), as ``jckx/serve.py:446-693``:

    - ``GET /healthz`` → JSON {status, step, conditional, num_classes,
      image_size, channels, batch_size, truncation};
    - ``GET /metrics`` → Prometheus text (requests, images, errors,
      latency sum, checkpoint step, serving batch size, and the latency's
      parts: ``jckx_generate_lock_wait_seconds_sum``, the wait for the
      sampling lock, ``jckx_generate_sample_seconds_sum``, the sampling
      under it, and ``jckx_generate_encode_seconds_sum``, the reply's
      ``.npy`` or PNG, summed over ``/generate`` and ``/interpolate``);
    - ``POST /generate`` {"n" ≤ 4096, "labels"?, "seed"?, "format": "png" |
      "npy"} → a PNG grid or an ``.npy`` uint8 (n, S, S, C);
    - ``POST /interpolate`` {"seed_a", "seed_b", "steps" in [2, 64]?,
      "label_a"?, "label_b"?, "kind"?, "format"?} → one walk.

    Bad requests get a JSON 400, unknown paths a 404, a failed render a JSON
    500. A POST is counted before its reply goes out (jckx counts it after),
    so a client that has its reply finds it in ``/metrics``. Requests run on
    handler threads, but sampling is serialized under one lock (one device
    pipeline, one set of graphs). Returns the not yet running
    ``ThreadingHTTPServer``, which carries ``swap_service(new_svc)``: a hot
    swap under the sampling lock; the counters persist across swaps. A
    swapped-in service captures its own graphs on its first request; the
    old service's graphs go with it once its last request is done, so two
    graph pools coexist only across a swap."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    lock = threading.Lock()
    current = {"svc": svc}

    def cur():
        return current["svc"]

    stats_lock = threading.Lock()
    stats = {"requests": 0, "images": 0, "errors": 0, "latency_sum": 0.0,
             "lock_wait_sum": 0.0, "sample_sum": 0.0, "encode_sum": 0.0}

    def _count(images: int = 0, error: bool = False, seconds: float = 0.0, requests: int = 1):
        with stats_lock:
            stats["requests"] += requests
            stats["images"] += images
            stats["errors"] += int(error)
            stats["latency_sum"] += seconds

    def _add(key: str, seconds: float):
        with stats_lock:
            stats[key] += seconds

    def _locked(call):
        """``call()`` under the sampling lock, the wait and the call timed."""
        t0 = time.perf_counter()
        lock.acquire()
        t1 = time.perf_counter()
        _add("lock_wait_sum", t1 - t0)
        try:
            return call()
        finally:
            lock.release()
            _add("sample_sum", time.perf_counter() - t1)

    def _is_int(v):  # JSON true / false are ints to isinstance
        return isinstance(v, int) and not isinstance(v, bool)

    def _error(code: int, msg: str):
        """A JSON error reply: (code, content type, body)."""
        return code, "application/json", json.dumps({"error": msg}).encode()

    def _images(imgs: np.ndarray, fmt: str, ncol: int):
        """Rendered uint8 images as a reply: an ``.npy`` or a PNG grid."""
        t0 = time.perf_counter()
        if fmt == "npy":
            buf = io.BytesIO()
            np.save(buf, imgs)
            reply = 200, "application/octet-stream", buf.getvalue()
        else:
            reply = 200, "image/png", encode_png(make_grid(imgs, ncol=ncol))
        _add("encode_sum", time.perf_counter() - t0)
        return reply

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet: the CLI owns stdout
            pass

        def _reply(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                with stats_lock:
                    snap = dict(stats)
                s = cur()
                body = "".join(f"# TYPE {k} {t}\n{k} {v}\n" for k, t, v in (
                    ("jckx_generate_requests_total", "counter", snap["requests"]),
                    ("jckx_generate_images_total", "counter", snap["images"]),
                    ("jckx_generate_errors_total", "counter", snap["errors"]),
                    ("jckx_generate_seconds_sum", "counter", round(snap["latency_sum"], 6)),
                    ("jckx_generate_lock_wait_seconds_sum", "counter",
                     round(snap["lock_wait_sum"], 6)),
                    ("jckx_generate_sample_seconds_sum", "counter", round(snap["sample_sum"], 6)),
                    ("jckx_generate_encode_seconds_sum", "counter", round(snap["encode_sum"], 6)),
                    ("jckx_checkpoint_step", "gauge", s.step),
                    ("jckx_serving_batch_size", "gauge", s.batch_size),
                ))
                return self._reply(200, "text/plain; version=0.0.4", body.encode())
            if self.path != "/healthz":
                return self._reply(*_error(404, "unknown path (GET /healthz or /metrics)"))
            s = cur()
            self._reply(200, "application/json", json.dumps({
                "status": "ok", "step": s.step, "conditional": s.conditional,
                "num_classes": s.num_classes, "image_size": s.geo.image_size,
                "channels": s.geo.channels, "batch_size": s.batch_size,
                "truncation": getattr(s, "truncation", 0.0),
            }).encode())

        def do_POST(self):
            if self.path == "/generate":
                handler = self._generate
            elif self.path == "/interpolate":
                handler = self._interpolate
            else:
                return self._reply(*_error(404, "unknown path (POST /generate or /interpolate)"))
            # counted before the body goes out: a client that has its reply
            # and reads /metrics next sees its own request
            t0 = time.perf_counter()
            try:
                n, reply = handler()  # image count (None on an error), the reply
            except Exception:  # noqa: BLE001 — e.g. the client hung up mid-read:
                n, reply = None, None  # the request must still be counted
            _count(images=n or 0, error=n is None, seconds=time.perf_counter() - t0)
            if reply is None:
                return
            try:
                self._reply(*reply)
            except Exception:  # noqa: BLE001 — the client hung up mid-write: an error,
                if n is not None:  # as jckx counts it, and still one request
                    _count(images=-n, error=True, requests=0)

        def _read_json(self):
            """→ (the request's JSON object, None) or (None, a 400 reply)."""
            try:
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                return req, None
            except ValueError as e:
                return None, _error(400, f"bad JSON body: {e}")

        # the POST handlers: → (image count, or None on an error; the reply)

        def _interpolate(self):
            s = cur()
            if not hasattr(s, "interpolate"):
                return None, _error(400, "this serving artifact has no interpolation path "
                                         "(serve a checkpoint, not a sealed *.pt2)")
            req, bad = self._read_json()
            if bad is not None:
                return None, bad
            for field in ("seed_a", "seed_b"):
                if not _is_int(req.get(field)):
                    return None, _error(400, f"'{field}' must be an int")
            # capped over HTTP, as jckx caps it (there each distinct value
            # compiles a program under the sampling lock)
            steps = req.get("steps", 10)
            if not _is_int(steps) or not 2 <= steps <= 64:
                return None, _error(400, "'steps' must be an int in [2, 64]")
            fmt = req.get("format", "png")
            if fmt not in ("png", "npy"):
                return None, _error(400, "'format' must be 'png' or 'npy'")
            kind = req.get("kind", "slerp")
            labs = {}
            for field in ("label_a", "label_b"):
                if field in req:
                    if not _is_int(req[field]):
                        return None, _error(400, f"'{field}' must be an int")
                    labs[field] = req[field]
            try:
                try:
                    imgs = _locked(lambda: s.interpolate(req["seed_a"], req["seed_b"],
                                                         steps=steps, kind=kind, **labs))
                except ValueError as e:  # the service's validation → a clear 400
                    return None, _error(400, str(e))
                return steps, _images(imgs, fmt, ncol=steps)
            except Exception as e:  # noqa: BLE001 — boundary: report, don't die
                return None, _error(500, f"generation failed: {type(e).__name__}: {e}")

        def _generate(self):
            s = cur()  # one consistent service per request, even mid-swap
            req, bad = self._read_json()
            if bad is not None:
                return None, bad
            n = req.get("n", 1)
            if not _is_int(n) or not 1 <= n <= 4096:
                return None, _error(400, "'n' must be an int in [1, 4096]")
            labels = req.get("labels")
            if labels is not None:
                if not s.conditional:
                    return None, _error(400, "'labels' given but the checkpoint is "
                                             "unconditional (DCGAN)")
                if (not isinstance(labels, list) or not labels
                        or not all(_is_int(x) and 0 <= x < s.num_classes for x in labels)):
                    return None, _error(400, f"'labels' must be a non-empty list of ints in "
                                             f"[0, {s.num_classes})")
            fmt = req.get("format", "png")
            if fmt not in ("png", "npy"):
                return None, _error(400, "'format' must be 'png' or 'npy'")
            seed = None
            if "seed" in req:
                if not _is_int(req["seed"]):
                    return None, _error(400, "'seed' must be an int")
                seed = req["seed"]
            try:  # a failed render comes back as a JSON 500, not a dropped connection
                imgs = _locked(lambda: s.sample(n, labels=labels, seed=seed))
                return n, _images(imgs, fmt, ncol=max(1, int(np.ceil(np.sqrt(n)))))
            except Exception as e:  # noqa: BLE001 — boundary: report, don't die
                return None, _error(500, f"generation failed: {type(e).__name__}: {e}")

    srv = ThreadingHTTPServer((host, port), Handler)

    def swap_service(new_svc):
        """Hot swap under the sampling lock: no request is mid-sample across
        the switch; requests that already took the old service finish on it."""
        with lock:
            current["svc"] = new_svc

    srv.swap_service = swap_service
    return srv


class CheckpointWatcher:
    """Poll a checkpoint file and hot-swap the serving service when it
    changes — the CLI's ``--watch``: a daemon pointed at a run's
    ``latest.ckpt`` follows the run (the trainer replaces it atomically).
    The file's signature is (mtime_ns, size). ``rebuild()`` makes the new
    service; a failed rebuild keeps the old one and retries on the next
    poll, since the signature moves only on a successful swap."""

    def __init__(self, srv, ckpt_path: str, rebuild, logger=None):
        self.srv, self.path, self.rebuild = srv, ckpt_path, rebuild
        self._logger = logger
        self._sig = self._stat()

    def _stat(self):
        st = os.stat(self.path)
        return (st.st_mtime_ns, st.st_size)

    def _log(self, msg):
        if self._logger is not None:
            self._logger(msg)

    def poll_once(self) -> bool:
        """→ True when a new checkpoint was swapped in."""
        try:
            sig = self._stat()
        except OSError:
            return False  # mid-replace or deleted; the next poll decides
        if sig == self._sig:
            return False
        try:
            new_svc = self.rebuild()
        except Exception as e:  # noqa: BLE001 — keep serving the old checkpoint
            self._log(f"--watch: reload of {self.path} failed ({type(e).__name__}: {e}) — "
                      f"still serving the previous checkpoint; will retry")
            return False
        self.srv.swap_service(new_svc)
        self._sig = sig
        self._log(f"--watch: now serving step-{new_svc.step} checkpoint")
        return True

    def run(self, interval_s: float, stop_event):
        while not stop_event.wait(interval_s):
            self.poll_once()


def get_args(argv=None):
    p = argparse.ArgumentParser(description="jckx_torch generator serving")
    p.add_argument("--ckpt", required=True,
                   help="the port's latest.ckpt or .pt, a reference torch .pt, a jckx .ckpt, or "
                        "a sealed .pt2 artifact (python -m jckx_torch export)")
    p.add_argument("-n", "--num", type=int, default=64)
    p.add_argument("-o", "--out", default="samples.png")
    p.add_argument("--conditional", action="store_true", default=None)
    p.add_argument("--labels", default="", help="comma-separated class ids (CGAN)")
    # overrides default to None = "from the weights"; one that contradicts them raises
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--channels", type=int, default=None)
    p.add_argument("--base_width", type=int, default=None)
    p.add_argument("--z_dim", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None, help="the render batch (default 512)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_shape", default="",
                   help="N = split every request batch over a local mesh of N devices "
                        "(cuda:0..N-1; 1-D only); '' = one device")
    p.add_argument("--listen", default="",
                   help="run as an HTTP daemon instead of writing a grid: 'PORT' or "
                        "'HOST:PORT' (GET /healthz, /metrics; POST /generate, /interpolate)")
    p.add_argument("--subpixel", type=int, default=0,
                   help="1 = the stride-2 ConvTranspose layers in the sub-pixel form")
    p.add_argument("--watch", type=float, default=0.0,
                   help="with --listen: poll the checkpoint every N seconds and hot-swap "
                        "the service when it changes; 0 = off")
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="int8 = the W8A8 sampler, calibrated from --seed at load")
    p.add_argument("--truncation", type=float, default=0.0,
                   help="draw z ~ N(0,1) truncated to [-t, t]; 0 = off")
    p.add_argument("--interpolate", default="",
                   help="SEEDA,SEEDB — write a latent walk between the two seeds to -o "
                        "(CGAN: --labels A[,B] picks the endpoint classes)")
    p.add_argument("--steps", type=int, default=10, help="frames in the --interpolate strip")
    p.add_argument("--kind", default="slerp", choices=["slerp", "lerp"])
    p.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain PyTorch path")
    return p.parse_args(argv)


def serving_mesh(spec: str, device=None):
    """``--mesh_shape``: a 1-D local mesh over ``cuda:0`` … ``cuda:N-1`` (on
    the CPU, N times the CPU). → None for ''."""
    shape = parse_mesh_shape(spec)
    if shape is None:
        return None
    if len(shape) != 1:
        # serving shards the request batch over ONE 'data' axis (jckx/serve.py:840-846)
        raise SystemExit(f"--mesh_shape for serving is 1-D (the request batch shards over a "
                         f"single 'data' axis); got {spec!r} — pass the total device count "
                         f"(e.g. '8')")
    dev = resolve_device(device)
    devices = ([dev] * shape[0] if dev.type != "cuda" else
               [torch.device("cuda", i) for i in range(shape[0])])
    if dev.type == "cuda" and shape[0] > torch.cuda.device_count():
        raise SystemExit(f"--mesh_shape {spec}: needs {shape[0]} CUDA devices, have "
                         f"{torch.cuda.device_count()}")
    return make_mesh(shape, (DATA_AXIS,), devices=devices)


def main(args) -> None:
    # cheap checks before the (slow) checkpoint load
    if args.ckpt.endswith(".jaxexp"):
        raise SystemExit(f"jckx_torch serve: --ckpt {args.ckpt}: {JAXEXP_REFUSAL}")
    mesh = serving_mesh(args.mesh_shape, args.device)
    listen_host, listen_port = "", 0
    if args.listen:
        listen_host, _, port_s = args.listen.rpartition(":")
        if not (port_s.isascii() and port_s.isdigit() and 1 <= int(port_s) <= 65535):
            raise SystemExit(f"--listen expects PORT or HOST:PORT with a port in [1, 65535], "
                             f"got {args.listen!r}")
        listen_port = int(port_s)
    if not args.listen and args.num < 1:
        raise SystemExit(f"-n/--num must be >= 1, got {args.num}")
    if args.interpolate and args.listen:
        raise SystemExit("--interpolate is the one-shot strip writer; with --listen use "
                         "POST /interpolate on the daemon")
    if args.watch > 0 and not args.listen:
        raise SystemExit("--watch needs --listen (it reloads a running daemon's checkpoint; "
                         "a one-shot render has nothing to reload)")
    overrides = {k: getattr(args, k) for k in GEOMETRY_FIELDS if getattr(args, k) is not None}
    if args.ckpt.endswith(".pt2"):
        from jckx_torch.export import ArtifactService

        if (overrides or args.conditional is not None or args.num_classes is not None
                or args.batch_size is not None or args.subpixel or args.quant
                or args.truncation or args.interpolate or mesh is not None):
            raise SystemExit(
                "--ckpt *.pt2 is a sealed artifact: geometry / conditioning / batch / mesh / "
                "subpixel / quant / truncation were fixed at export time (and interpolation "
                "needs the live sampler): re-export, or serve the checkpoint instead")

        def build_svc():
            return ArtifactService(args.ckpt, seed=args.seed, device=args.device)
    else:
        def build_svc():
            return GeneratorService(
                args.ckpt, conditional=args.conditional, num_classes=args.num_classes,
                geo_overrides=overrides or None,
                batch_size=512 if args.batch_size is None else args.batch_size,
                seed=args.seed, subpixel=bool(args.subpixel), quant=args.quant or None,
                truncation=args.truncation, device=None if mesh is not None else args.device,
                mesh=mesh)

    svc = build_svc()
    if args.listen:
        import signal

        srv = make_http_server(svc, listen_host or "0.0.0.0", listen_port)

        def _stop(signum, frame):  # SIGTERM / SIGINT: a clean shutdown
            threading.Thread(target=srv.shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
        stop_watch = threading.Event()
        if args.watch > 0:
            watcher = CheckpointWatcher(srv, args.ckpt, build_svc,
                                        logger=lambda m: print(m, flush=True))
            threading.Thread(target=watcher.run, args=(args.watch, stop_watch), daemon=True,
                             name="jckx-ckpt-watch").start()
        print(f"serving step-{svc.step} checkpoint on http://{srv.server_address[0]}:"
              f"{srv.server_address[1]} (GET /healthz, /metrics; POST /generate, /interpolate"
              + (f"; --watch {args.watch:g}s" if args.watch > 0 else "") + ")", flush=True)
        try:
            srv.serve_forever()
        finally:
            stop_watch.set()
            srv.server_close()
        return
    labels = [int(x) for x in args.labels.split(",") if x] or None
    if args.interpolate:
        try:
            seed_a, seed_b = (int(x) for x in args.interpolate.split(","))
        except ValueError:
            raise SystemExit(f"--interpolate expects SEEDA,SEEDB (two ints), got "
                             f"{args.interpolate!r}")
        lab_a = labels[0] if labels else None
        lab_b = labels[1] if labels and len(labels) > 1 else lab_a
        imgs = svc.interpolate(seed_a, seed_b, steps=args.steps, label_a=lab_a, label_b=lab_b,
                               kind=args.kind)
        save_image_grid(args.out, imgs, ncol=args.steps)
        print(f"wrote a {args.steps}-frame {args.kind} walk ({seed_a}->{seed_b}, step "
              f"{svc.step} checkpoint) to {args.out}")
        return
    imgs = svc.sample(args.num, labels=labels)
    save_image_grid(args.out, imgs)
    print(f"wrote {args.num} samples (step {svc.step} checkpoint) to {args.out}")


if __name__ == "__main__":
    main(get_args())
