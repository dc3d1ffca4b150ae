"""Smoke test of the PyTorch/CUDA port (``jckx_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``. It imports nothing of JAX or of the JAX package, and:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from the checkout's sources;
3. holds each kernel against its plain PyTorch version on the card
   (relu / leaky_relu(0.2) / none, bf16 and f32, the four generator
   shapes at batch 512 and two ragged shapes): f32 within 1e-5 (an FMA
   against a separate multiply and add), bf16 within one bf16 ulp
   plus that 1e-5;
4. serves requests through ``GeneratorService`` at the reference's full
   width (DCGAN 64², z 100, base width 64; weights drawn from a seed and
   saved in the reference ``.pt`` format), at batch 512 in bf16, with the
   launch counter reset just before and read just after: it must read
   4 launches per rendered batch. The served uint8 images for one z must
   match the plain path on the card within 1 LSB, >= 99.9 % exactly;
5. times each generator layer's kernel against its bound (bytes over the
   H100 SXM's 3.35 TB/s), its plain version and ``F.batch_norm`` + ReLU,
   and the served images per second, beside the card's name and power
   limit, and profiles one served request (the card's busy share and its
   time by kernel);
6. prints a ``{"kernels": [...]}`` line, then, last, the
   ``{"ok": true, "device": {...}}`` line.

Any failed phase exits nonzero before the last line is printed. Without a
card, or outside a checkout of the repo, it exits nonzero at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, f32 outside the tensor cores
BATCH = 512
G_LAYERS = [(4, 512), (8, 256), (16, 128), (32, 64)]  # (spatial, channels) of G's BN layers
RAGGED = [(1000, 3), (8 * 7 * 7, 100)]                 # (rows, C)
SLEEP_CYCLES = 20_000_000   # ~10 ms: the host enqueues a timed loop while the card waits


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bf16_ulp_ok(a, b) -> bool:
    """Every element of a and b within one bf16 ulp of the larger magnitude,
    plus the f32 tolerance 1e-5: near zero, where x*inv and shift cancel,
    the FMA and the separate multiply and add may round to either side."""
    import torch

    a, b = a.float(), b.float()
    m = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7), torch.zeros_like(m))
    return bool(((a - b).abs() <= ulp + 1e-5).all())


def device_ms(fn, inputs, iters: int = 20) -> float:
    """Device time of one ``fn(*inputs[i])``, in ms: the card sleeps while
    the host enqueues the loop, so the events time the card, not the host.
    ``inputs`` rotate so that the loop streams from HBM, not from L2."""
    import torch

    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotation(make, nbytes: int, budget: int = 200 << 20) -> list:
    """Enough distinct inputs from ``make()`` to exceed the 50 MB L2 4x."""
    return [make() for _ in range(max(2, math.ceil(budget / nbytes)))]


def phase_environment():
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi exited {smi.returncode}: {smi.stderr}")
    card = smi.stdout.strip()
    print(card)
    print(f"device 0: {kind}; device count {torch.cuda.device_count()}")
    return kind, card


def phase_build():
    from jckx_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, so in paths.items():
        with open(so + ".log") as f:
            log = f.read()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
              f"{spills} bytes of spill stores (ptxas)")
    return paths


def phase_kernel_vs_plain(dev) -> float:
    """Kernel against its plain version on the same inputs. → max |err|."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba

    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [(BATCH * s * s, c) for s, c in G_LAYERS] + RAGGED
    worst = 0.0
    for rows, chans in shapes:
        x32 = torch.randn(rows, chans, generator=g, device=dev) * 2 + 0.5
        inv = torch.rand(chans, generator=g, device=dev) + 0.5
        shift = torch.randn(chans, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for act in ("relu", "leaky_relu", "none"):
                y = fba.normalize_act(x, inv, shift, act, 0.2)
                ref = fba.normalize_act_plain(x, inv, shift, act, 0.2)
                torch.cuda.synchronize()
                check(y.dtype == dtype and y.shape == x.shape, f"kernel output {y.dtype} {y.shape}")
                err = (y.float() - ref.float()).abs().max().item()
                worst = max(worst, err)
                ok = err <= 1e-5 if dtype == torch.float32 else bf16_ulp_ok(y, ref)
                check(ok, f"kernel vs plain: rows={rows} C={chans} {dtype} {act}: max |err| {err}")
    # the whole wrapper (statistics + kernel) on the generator's NCHW channels_last tensors
    for s, c in G_LAYERS:
        x = torch.randn(BATCH, c, s, s, generator=g, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last)
        scale = torch.rand(c, generator=g, device=dev) + 0.5
        bias = torch.randn(c, generator=g, device=dev)
        y = fba.bn_act(x, scale, bias, act="relu")
        ref = fba.bn_act_plain(x, scale, bias, act="relu")
        torch.cuda.synchronize()
        check(y.is_contiguous(memory_format=torch.channels_last), "bn_act output not channels_last")
        check(bf16_ulp_ok(y, ref), f"bn_act vs bn_act_plain at {s}x{s}x{c}")
    print(f"kernel vs plain: {len(shapes) * 6 + len(G_LAYERS)} comparisons passed, "
          f"max |err| {worst} (f32 <= 1e-5, bf16 <= 1 ulp + 1e-5)")
    return worst


def write_reference_checkpoint(path: str, seed: int = 0):
    """Random weights at the reference geometry, saved as the reference
    trainer saves them (train/dcgan_trainer.py:86-91)."""
    import torch

    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator

    gen = torch.Generator().manual_seed(seed)
    geo = GANGeometry()
    g, d = Generator(geo, gen=gen), Discriminator(geo, gen=gen)
    n_g = sum(p.numel() for p in g.parameters())
    check(n_g == 3_576_704, f"G has {n_g} parameters, the reference 3,576,704")
    torch.save({
        "model_g": g.state_dict(), "model_d": d.state_dict(),
        "optimizer_g": torch.optim.Adam(g.parameters(), lr=2e-4, betas=(0.5, 0.999)).state_dict(),
        "optimizer_d": torch.optim.Adam(d.parameters(), lr=2e-4, betas=(0.5, 0.999)).state_dict(),
    }, path)
    return geo


def phase_serve(path: str, geo):
    """The main path: requests through the service. → (service, launches)."""
    import numpy as np

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.serve import GeneratorService

    svc = GeneratorService(path)  # the defaults: cuda, batch 512, bf16
    check(svc.device.type == "cuda" and svc.batch_size == BATCH, "service defaults")
    shape = (geo.image_size, geo.image_size, geo.channels)
    fba.LAUNCHES = 0
    a = svc.sample(64, seed=1)       # one padded batch
    b = svc.sample(1000)             # two batches, the second trimmed
    c1 = svc.sample(64, seed=7)
    c2 = svc.sample(64, seed=7)
    launches = fba.LAUNCHES
    batches = sum(math.ceil(n / svc.batch_size) for n in (64, 1000, 64, 64))
    for imgs, n in ((a, 64), (b, 1000), (c1, 64), (c2, 64)):
        check(imgs.dtype == np.uint8 and imgs.shape == (n, *shape), f"served {imgs.dtype} {imgs.shape}")
        check(imgs.std() > 1.0, "served images are flat")
    check(c1.tobytes() == c2.tobytes(), "the same seed gave different images")
    check(a.tobytes() != c1.tobytes(), "two seeds gave the same images")
    check(launches == 4 * batches, f"{launches} kernel launches for {batches} batches, want {4 * batches}")
    print(f"served 64 + 1000 + 64 + 64 images in {batches} batches of {svc.batch_size}: "
          f"{launches} kernel launches")
    return svc, launches


def phase_serve_vs_plain(svc, dev):
    """The service's uint8 output on one z against the plain path on the card."""
    import torch

    import jckx_torch.models.dcgan as tdcgan
    from jckx_torch.kernels import fused_bn_act as fba

    z = torch.randn(BATCH, svc.geo.z_dim, generator=torch.Generator(device=dev).manual_seed(123),
                    device=dev)
    got = svc.render(z)
    tdcgan.bn_act = fba.bn_act_plain
    try:
        ref = svc.render(z)
    finally:
        tdcgan.bn_act = fba.bn_act
    diff = (got.int() - ref.int()).abs()
    exact = (diff == 0).float().mean().item()
    print(f"served uint8 vs plain path on the same z: max diff {diff.max().item()} LSB, "
          f"{100 * exact:.4f} % exactly equal")
    check(diff.max().item() <= 1 and exact >= 0.999, "served images disagree with the plain path")


def phase_timing(svc, dev, card: str):
    """Per-layer kernel / plain / library times and served img/s. → kernel totals."""
    import torch
    import torch.nn.functional as F

    from jckx_torch.kernels import fused_bn_act as fba

    g = torch.Generator(device=dev).manual_seed(1)
    rows_out = []
    for s, c in G_LAYERS:
        rows = BATCH * s * s
        nbytes = rows * c * 2
        xs = rotation(lambda: torch.randn(BATCH, c, s, s, generator=g, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last), nbytes)
        scale = torch.rand(c, generator=g, device=dev) + 0.5
        bias = torch.randn(c, generator=g, device=dev)
        inv = torch.rand(c, generator=g, device=dev) + 0.5
        shift = torch.randn(c, generator=g, device=dev)
        x2ds = [(fba._rows(x), inv, shift) for x in xs]
        ms = device_ms(lambda x, i, t: fba.normalize_act(x, i, t, "relu"), x2ds)
        plain = device_ms(lambda x, i, t: fba.normalize_act_plain(x, i, t, "relu"), x2ds)
        full = device_ms(lambda x: fba.bn_act(x, scale, bias, act="relu"), [(x,) for x in xs])
        lib = device_ms(lambda x: F.relu_(F.batch_norm(x, None, None, scale, bias, training=True,
                                                        eps=1e-5)), [(x,) for x in xs])
        moved = 2 * nbytes + 2 * c * 4           # x read, y written, inv + shift read
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = 3 * rows * c / F32_FLOPS_PER_S * 1e3  # FMA + activation, f32
        bound = max(bytes_ms, ops_ms)
        rows_out.append({"layer": f"{s}x{s}x{c}", "rows": rows, "C": c, "ms": ms, "bound_ms": bound,
                         "bytes_ms": bytes_ms, "ops_ms": ops_ms, "plain_ms": plain,
                         "bn_act_ms": full, "library_ms": lib})
        print(f"  layer {s:>2}x{s:<2}x{c:<3} kernel {ms * 1e3:8.2f} us  bound {bound * 1e3:6.2f} us "
              f"({100 * bound / ms:5.1f} %)  plain {plain * 1e3:8.2f} us  bn_act (stats + kernel) "
              f"{full * 1e3:8.2f} us  F.batch_norm + relu {lib * 1e3:8.2f} us   [{card}]")
    print("bn_act_layers " + json.dumps({"card": card, "batch": BATCH, "dtype": "bfloat16",
                                         "layers": rows_out}))

    z = torch.randn(BATCH, svc.geo.z_dim, generator=g, device=dev)
    render_ms = device_ms(lambda zz: svc.render(zz), [(z,)], iters=10)
    bn_share = sum(r["bn_act_ms"] for r in rows_out) / render_ms
    print(f"one render at batch {BATCH}, bf16: {render_ms:.3f} ms on the card, of which bn_act "
          f"{100 * bn_share:.1f} % (its statistics {100 * (bn_share - sum(r['ms'] for r in rows_out) / render_ms):.1f} %)"
          f"   [{card}]")
    # served throughput on the host clock: 8 batches a request, 5 requests
    n = 8 * BATCH
    svc.sample(BATCH, seed=0)  # warm
    walls = []
    for i in range(5):
        t0 = time.perf_counter()
        svc.sample(n, seed=1 + i)
        walls.append(time.perf_counter() - t0)
    rates = sorted(n / w for w in walls)
    print(f"serving at batch {BATCH}, bf16: median {rates[2]:.1f} img/s over 5 requests of {n} images "
          f"(min {rates[0]:.1f}, max {rates[-1]:.1f}; {sorted(walls)[2] * 1e3 / 8:.3f} ms per batch "
          f"on the host clock)   [{card}]")
    # where the host's time per batch goes
    u8 = svc.render(z)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        svc.render(z)
    enqueue = (time.perf_counter() - t0) / 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        u8.cpu()
    copy = (time.perf_counter() - t0) / 8
    print(f"host per batch: render enqueued in {enqueue * 1e3:.3f} ms, uint8 payload "
          f"({u8.numel() / 2**20:.1f} MiB) copied to fresh pageable memory in {copy * 1e3:.3f} ms"
          f"   [{card}]")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out = {k: sum(r[k] for r in rows_out) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    out["bound_by"] = "bytes" if all(r["bytes_ms"] >= r["ops_ms"] for r in rows_out) else "operations"
    return out


def phase_profile(svc, card: str) -> None:
    """One served request of 8 batches under ``torch.profiler``: the card's
    busy share of the window and its time by kernel. Informational: prints
    "not measured" where the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    svc.sample(BATCH, seed=0)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.sample(8 * BATCH, seed=99)
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print(f"profiled request: the profiler saw no device activity; busy share not measured"
              f"   [{card}]")
        return
    window = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:  # union of the device intervals
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy += hi - lo
    by_name = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.end - e.time_range.start, k + 1)
    total = sum(t for t, _ in by_name.values())
    print(f"profiled request of {8 * BATCH} images at batch {BATCH}, bf16: window {window / 1e3:.3f} ms, "
          f"card busy {busy / 1e3:.3f} ms ({100 * busy / window:.1f} %, idle {100 - 100 * busy / window:.1f} %)"
          f"   [{card}]")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3:8.3f} ms {100 * t / total:5.1f} %  x{k:<4} {name[:90]}")


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "jckx_torch")):
        fail("jckx_torch/ is not beside chip_smoke.py: run it from a checkout of the repo")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    kind, card = phase_environment()
    phase_build()
    max_err = phase_kernel_vs_plain(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dcgan_seed0.pt")
        geo = write_reference_checkpoint(path)
        svc, launches = phase_serve(path, geo)
    phase_serve_vs_plain(svc, dev)
    t = phase_timing(svc, dev, card)
    phase_profile(svc, card)
    print(json.dumps({"kernels": [{
        "name": "fused_bn_act", "route": "cuda",
        "source": "jckx_torch/kernels/csrc/fused_bn_act.cu",
        "replaces": "jckx/kernels/fused_bn_act.py:120",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
