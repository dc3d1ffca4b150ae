"""Card checks of the PyTorch/CUDA port (``jckx_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``. It imports nothing of JAX or of the JAX package. It holds what
neither of the other two harnesses holds: it drives the port's entry
points and commands end to end on the card, and it times the hand-written
kernels alone. The kernels, steps and graphs against their plain versions
are ``python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py``;
rates, traces and the per-layer metrics are the benchmark's
(``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace 1``). In order, it:

1. prints the card's name and power limit (``nvidia-smi``), and builds
   every CUDA kernel of the port from the checkout's sources (ptxas's
   registers and spills printed);
2. serves through ``GeneratorService`` at the reference's full width
   (DCGAN 64², z 100, base width 64; CGAN with K = 100, with and without
   ``labels``; weights drawn from a seed and saved in the reference
   ``.pt`` format), bs512 bf16: 4 kernel launches per rendered batch, a
   labelled CGAN batch equal to its z rendered with the explicit one-hot;
   the int8 (DCGAN, CGAN with labels), sub-pixel and truncated (t 0.7)
   samplers and interpolation (16 frames; an int8 CGAN class morph):
   renders bit-identical to the plain route rounded once and within 1 LSB
   of ``bn_act_plain`` (int8: 4 LSB on all but 1 % of the pixels, its
   flipped int8 activations printed per layer), truncated z within [-t,
   t], strips byte-identical across calls and equal to the render of their
   latents, the f32 sub-pixel sampler within 1 LSB of the default;
3. runs the HTTP daemon in this process on 127.0.0.1:0 (``/healthz``,
   ``/generate`` npy equal to ``sample()``, png by signature and size,
   ``/interpolate``, ``/metrics`` counters, the 400s and a 404, a request
   of 4096, CGAN labels);
4. exports ``torch.export`` artifacts on the card (DCGAN bf16 at jckx's
   batch of 64, CGAN with labels, DCGAN int8) and serves each from a fresh
   ``ArtifactService``: 4 launches per batch, bit-identical to the
   service on ``rng.normal_from_seed``'s z, within 1 LSB of the plain
   route (int8: 4 LSB, 97.5 % exact at batch 64); one ``/generate`` over
   a ``.pt2``;
5. the tools through ``python -m jckx_torch``: ``convert`` .pt →
   checkpoint → .pt with equal tensors, ``inspect`` of every kind with no
   card visible, ``doctor`` exiting 0;
6. serves over a local mesh ``[cuda:0, cuda:0]`` within 1 LSB of the
   unsharded service (≥ 99 % exact), 4 launches per device per batch; the
   served renders on one z against the plain route and against the plain
   route with the plain sums (``plain_sums``): within 1 LSB;
7. times the kernels alone, beside the card's name and power limit:
   ``phase_timing`` (the normalize kernel per G BN layer at bs512 bf16
   against its bound at 3.35 TB/s, its plain version, the wrapper, the
   library's ``F.batch_norm`` + ReLU), ``phase_moments`` (the BN
   statistics' kernels at the same layers: their sums against f64 beside
   the plain route's, the same bits twice, each layer's time against its
   bound, the plain route and one ``torch.sum``; then each distinct map
   of the fine-tune's 94, bs128 bf16, and their sum over a step);
   ``phase_timing`` also times the fine-tune's largest BN map and holds
   the kernel within one bf16 ulp of its plain version at each shape it
   times;
   ``phase_bwd_timing`` (the fine-tune's BN + ReLU backward kernels at
   three of its maps against their bound and the plain backward);
   ``phase_biggan_kernels`` (BigGAN-128's conditional normalize at G's ten
   conditional maps and its residual sum at the five sums, bs256 bf16:
   bit for bit their once-rounded and plain versions, their times against
   their bound and plain versions, and their launches in one served
   BigGAN replay by the profiler: 10 and 5);
   ``phase_bn_relu_train``: the fine-tune's BN + ReLU (forward and
   backward) against its plain version at three of its maps, bf16;
8. one full-width train step (DCGAN and CGAN with K = 100, faithful and
   FusedProp, f32) on the card against the CPU: telemetry, the masked
   Adam deltas, no launch; ``--remat none|g|d|both`` on a full-width DCGAN
   step: the parameters
   against ``none``'s and the peak device memory; ``--sanitize``: a clean
   step equals the plain one bit for bit, a NaN raises naming the backward
   function; one fine-tune step at 299², batch 8, f32 on the card against
   the CPU (loss, SGD deltas, running statistics, 94 launches);
9. trains DCGAN, DCGAN with ``--fused_prop 1`` and CGAN through
   ``jckx_torch.train.main`` (4096 synthetic rows, bs128, bf16, 32 steps,
   evals after 8, 16 and 32; checkpoints and grids): 4 launches per DCGAN
   eval, 8 per CGAN eval, none from the steps; the eval sample against the
   plain routes as in 2; ``--resume`` trains nothing; a ``--watch`` daemon
   swaps the DCGAN run's step-8 checkpoint for its last on one poll; a
   ``--profile_dir`` run writes a Chrome trace naming the kernel and its
   graph replays; the jckx ``.ckpt`` fixture (tests/data/jckx_ckpt)
   through ``evaluate``, ``convert``, ``inspect`` and ``train --resume``;
10. scores the CGAN run with ``evaluate`` and ``-t 1`` (the logged FID / IS
    / intra-FID within 1 %), ``evaluate --quant int8`` (the params served
    with the same calibration seed) and ``evaluate --kid 1 --prdc 1
    --eval_fast_stem 1`` (KID and PRDC against float64, also on an
    overlapping pair; the s2d stem against the plain one); a two-seed
    ``panel``; fine-tunes InceptionV3 through ``finetune``'s ``train()``
    (299², bs128, bf16, 2 epochs of 8 steps: 94 launches a step, the
    ``.npz`` files, ``--resume 1``) and scores the CGAN run over it;
11. holds the trainers' graphed eval renders, ``evaluate``'s renders,
    features and scores, and the features of 10,000 fakes and of the real
    set against their eager routes, bit for bit
    (``phase_inference_graph``);
12. the data planes, in a child process: the native I/O library loads; a
    50,000-row CIFAR-100 pickle parsed, cached and mapped; the metrics
    engine's slab path against its per-batch path; CGAN streamed under
    ``auto`` and cut by SIGTERM; the folder plane;
13. the mesh in child processes sharing the card (``phase_mesh``,
    ``phase_mesh_graph``, ``phase_mesh_model``): a NCCL world of one
    bit-identical to the plain run; gloo pairs of DCGAN and CGAN against the
    plain run on their first step; a two-rank fine-tune against one rank;
    the superstep, the eval program and the fine-tune's launch over a NCCL
    world of one, plain and forced live, bit for bit against eager with
    ``mesh.stats`` counting each replay's collectives; the model axis (tp,
    spatial, ``--spatial_replicate_grads 0``) against the plain run, its
    eval renders through the kernel, the TP checkpoint served;
14. the capacity planner (``phase_plan``): ``python -m jckx_torch plan
    --device cuda`` on five meshes, every report's memory read on the card
    and fitting, the TP and spatial reports' collectives against a gloo
    pair's, the planned temporaries against a real step's, the f32 FLOPs
    against jckx's count;
15. prints a ``{"kernels": [...]}`` line (each kernel's launches on the
    paths above, BigGAN's two kernels' in one served replay, its error,
    its times per G forward or BigGAN render), then, last, the
    ``{"ok": true, "device": {...}}`` line.

Wherever a phase reads the normalize kernel's launches (``LAUNCHES``) it
reads the BN statistics' moments kernels' too (``MOMENTS_LAUNCHES``,
``check_moments``): two for each launch of a G or D forward that takes no
gradient and of each fine-tune BN layer's forward, none in a differentiated
GAN step; children record their own. The ``bn_moments`` entry of the
kernels line sums these paths' counts. Every train run and served batch on
one card without a gloo mesh goes through its CUDA graph; comparisons with
the plain routes call the programs eagerly (``with_bn_act``). ``time:``
lines give the script's own seconds by group of phases.

Any failed check exits nonzero before the last line is printed. Without a
card, or outside a checkout of the repo, it exits nonzero at once.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, f32 outside the tensor cores
BATCH = 512
G_LAYERS = [(4, 512), (8, 256), (16, 128), (32, 64)]  # (spatial, channels) of G's BN layers
SLEEP_CYCLES = 20_000_000   # ~10 ms: the host enqueues a timed loop while the card waits
TRAIN_BATCH, TRAIN_LR = 128, 2e-4  # jckx's batch; the lr bench.py:63 trains at
EVAL_BATCH = 64             # the trainer's sample_count: G's batch at every eval
CGAN_CHUNK = 500            # the CGAN trainer's eval rows per G forward (gan_trainer.EVAL_CHUNK)
CGAN_CLASSES = 100          # the reference CGAN's K (model/CGAN.py)
EXPORT_BATCH = 64           # jckx's export batch (jckx/export.py:263)
# int8 artifact at batch 64 against the plain route: a one-ulp f32
# difference at a quantization boundary flips an int8 activation, and the
# flips reach more pixels at batch 64 than at 512 (measured on an H100:
# 98.0844 % exact for seed-0 DCGAN, seeds 0, 1, 7; 99.7803 % at 512)
INT8_EXACT_BS64 = 0.975
SERVE_LABELS = [3, 17, 42]
FT_BATCH, FT_SIZE = 128, 299  # the notebook's fine-tune batch and input side
FT_CONVS = 94                 # InceptionV3's BasicConv2d layers: one kernel launch each per step
# (C, side) at bs128, 299²: the fine-tune's two largest BN maps (stem) and a
# Mixed_7c map; the first is timed
FT_BN_SHAPES = [(64, 147), (32, 149), (448, 8)]
DATA_ROWS = 50_000             # CIFAR-100's train split, planted as its pickle
FEATURE_ROWS = 10_000          # rows whose InceptionV3 features are held path against path
FEATURE_SLAB_BYTES = 8 << 20   # 10,000 rows of 32² (30.7 MB) in 4 slabs of 10 batches


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


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


def rotation(make, nbytes: int, budget: int = 200 << 20, cap: int = 64) -> list:
    """Enough distinct inputs from ``make()`` to exceed the 50 MB L2 4x (at
    most ``cap``: a small input is timed over a cap's worth)."""
    return [make() for _ in range(min(cap, max(2, math.ceil(budget / nbytes))))]


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




@contextlib.contextmanager
def programs_eager():
    """Every graphed program (``utils/graphs.GraphedProgram``) calls its
    function eagerly meanwhile: a replay runs what its capture recorded,
    so it would not see a swapped BN route, nor run Python to record."""
    from jckx_torch.utils.graphs import GraphedProgram

    call = GraphedProgram.__call__
    GraphedProgram.__call__ = lambda self, *args: self.fn(*args)
    try:
        yield
    finally:
        GraphedProgram.__call__ = call


@contextlib.contextmanager
def eager_route(obj, attr: str = "program"):
    """``obj``'s eager route: its graphed program set to None meanwhile."""
    program = getattr(obj, attr)
    setattr(obj, attr, None)
    try:
        yield program
    finally:
        setattr(obj, attr, program)


# The moments kernels' launches of every path a phase checked
# (``check_moments``), children's included: the kernels line sums them, so
# ``phase_moments``' own calls are not among them.
MOMENTS_ON_PATHS = []
# The BN + ReLU backward's launches of every path that checked them against
# its normalize launches (``check_bwd``): the kernels line sums them, so
# ``phase_bwd_timing``' own calls are not among them.
BWD_ON_PATHS = []
# The moments kernels' launches inside int8 calibrations since the counters
# were zeroed (``count_calibrations``).
CALIBRATION_MOMENTS = [0]


def count_calibrations() -> None:
    """Wrap ``ops/quant.calibrate_generator``, which ``make_sampler`` calls
    for an int8 sampler: its float forwards take ``bn_act_plain`` under
    inference mode, so on the card each BN layer of each probe batch
    launches the moments kernels (2) and no normalize kernel. The wrapper
    checks that count and keeps it in ``CALIBRATION_MOMENTS``, which
    ``launch_counts`` takes off."""
    import jckx_torch.ops.quant as tquant
    from jckx_torch.kernels import fused_bn_act as fba

    real = tquant.calibrate_generator

    def calibrate_generator(G, probes, *args, **kw):
        before = (fba.LAUNCHES, fba.MOMENTS_LAUNCHES)
        out = real(G, probes, *args, **kw)
        m = fba.MOMENTS_LAUNCHES - before[1]
        want = 2 * len(probes) * G.geo.n_up if G.conv1.weight.is_cuda else 0
        check(fba.LAUNCHES == before[0] and m == want,
              f"an int8 calibration launched {fba.LAUNCHES - before[0]} normalize and {m} "
              f"moments kernels, want 0 and {want}")
        CALIBRATION_MOMENTS[0] += m
        return out

    tquant.calibrate_generator = calibrate_generator


def zero_launches() -> None:
    """Zero the kernel counters: the normalize kernel's (``LAUNCHES``), the
    BN statistics' moments kernels' (``MOMENTS_LAUNCHES``) and the BN + ReLU
    backward's (``BWD_LAUNCHES``)."""
    from jckx_torch.kernels import fused_bn_act as fba

    fba.LAUNCHES = fba.MOMENTS_LAUNCHES = fba.BWD_LAUNCHES = CALIBRATION_MOMENTS[0] = 0


def launch_counts() -> tuple:
    """(``LAUNCHES``, ``MOMENTS_LAUNCHES`` less the int8 calibrations')
    now."""
    from jckx_torch.kernels import fused_bn_act as fba

    return fba.LAUNCHES, fba.MOMENTS_LAUNCHES - CALIBRATION_MOMENTS[0]


def check_moments(what: str, launches: int, moments: int = None) -> int:
    """A path's moments-kernel launches against its normalize launches, 2
    each: every normalize launch follows one ``bn_moments`` (the partial
    sums, then their combine), in a ``bn_act`` that took no gradient and in
    each forward of the fine-tune's ``bn_relu_train``; a differentiated GAN
    step launches neither. ``moments`` None reads ``launch_counts()``,
    zeroed with ``LAUNCHES`` (``zero_launches``). The count joins the
    kernels line's. → it."""
    m = launch_counts()[1] if moments is None else moments
    check(m == 2 * launches, f"{what}: {m} moments-kernel launches for {launches} normalize "
                             f"launches, want {2 * launches}")
    MOMENTS_ON_PATHS.append(m)
    return m


def check_bwd(what: str, launches: int, bwd: int) -> int:
    """A path's BN + ReLU backward launches against its normalize launches:
    three each on the card (the sums, their combine, dx) where every
    launch was a ``bn_relu_train`` that took a gradient, as each step of
    the fine-tune does. The count joins the kernels line's. → it."""
    check(bwd == 3 * launches, f"{what}: {bwd} backward-kernel launches for {launches} "
                               f"normalize launches, want {3 * launches}")
    BWD_ON_PATHS.append(bwd)
    return bwd


@contextlib.contextmanager
def plain_sums():
    """While inside, ``_stats`` takes the plain sums (``bn_moments_plain``)
    wherever it would take the moments kernels: a reference route that
    shares no code with them."""
    from jckx_torch.kernels import fused_bn_act as fba

    op = fba.bn_moments_op
    fba.bn_moments_op = fba.bn_moments_plain
    try:
        yield
    finally:
        fba.bn_moments_op = op


def with_bn_act(bn, render):
    """``render()`` with every generator BN layer, of the float and of the
    int8 forward, routed through ``bn`` (and every graphed program eager)."""
    import jckx_torch.models.dcgan as tdcgan
    import jckx_torch.ops.quant as tquant

    kernel_route = tdcgan.bn_act
    tdcgan.bn_act = tquant.bn_act = bn
    try:
        with programs_eager():
            return render()
    finally:
        tdcgan.bn_act = tquant.bn_act = kernel_route


def check_u8_agree(render, what: str, max_lsb: int = 1, min_exact: float = 0.0) -> None:
    """uint8 images of ``render()`` through the kernel against the plain
    routes on the same inputs. The plain route rounds the multiply-add
    twice where the kernel's FMA rounds once; under bf16 and batch
    statistics a one-ulp difference spreads through the later layers, and
    how far depends on the weights (ROADMAP C): so within ``max_lsb`` of it
    (1 unless the caller states another), at least ``min_exact`` of the
    pixels exactly equal, its exact share printed. The plain route with the
    multiply-add rounded once must give the same bytes."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba

    got = render()
    plain = with_bn_act(fba.bn_act_plain, render)
    once = with_bn_act(fba.bn_act_one_rounding, render)
    diff = (got.int() - plain.int()).abs()
    exact = (diff == 0).float().mean().item()
    same = torch.equal(got, once)
    print(f"{what} vs the plain route on the same inputs: max diff {diff.max().item()} LSB, "
          f"{100 * exact:.4f} % exactly equal; vs the plain route rounded once: "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    check(diff.max().item() <= max_lsb and exact >= min_exact,
          f"{what} differ from the plain route by more than {max_lsb} LSB or on more than "
          f"{100 * (1 - min_exact):g} % of the pixels")
    check(same, f"{what} differ from the plain route with the kernel's rounding")


def write_reference_checkpoint(path: str, seed: int = 0, conditional: bool = False):
    """Random weights at the reference geometry, saved as the reference
    trainers save them (train/dcgan_trainer.py:86-91, cgan_trainer.py:82-87):
    DCGAN, or CGAN with K = 100."""
    import torch

    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator

    gen = torch.Generator().manual_seed(seed)
    geo = GANGeometry()
    if conditional:
        g, d = CGenerator(geo, CGAN_CLASSES, gen=gen), CDiscriminator(geo, CGAN_CLASSES, gen=gen)
        want = (4_395_904, 4_926_569)
    else:
        g, d = Generator(geo, gen=gen), Discriminator(geo, gen=gen)
        want = (3_576_704, 2_765_696)
    have = tuple(sum(p.numel() for p in net.parameters()) for net in (g, d))
    check(have == want, f"G, D have {have} parameters, the reference {want}")
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
    zero_launches()
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
    check_moments("served DCGAN requests", launches)
    print(f"served 64 + 1000 + 64 + 64 images in {batches} batches of {svc.batch_size}: "
          f"{launches} kernel launches")
    return svc, launches


def phase_serve_cgan(path: str, geo, dev):
    """The CGAN serving path: requests with and without labels. → (service,
    launches)."""
    import numpy as np
    import torch

    from jckx_torch.data.pipeline import one_hot
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.serve import GeneratorService, _request_seed, tanh_to_u8

    svc = GeneratorService(path)  # the defaults: cuda, batch 512, bf16
    check(svc.conditional and svc.num_classes == CGAN_CLASSES and svc.batch_size == BATCH,
          f"CGAN service: conditional {svc.conditional}, K {svc.num_classes}")
    shape = (geo.image_size, geo.image_size, geo.channels)
    requests = [(64, SERVE_LABELS, 1), (1000, SERVE_LABELS, None), (600, None, None),
                (64, None, 7), (64, None, 7)]
    zero_launches()
    out = [svc.sample(n, labels=lab, seed=seed) for n, lab, seed in requests]
    launches = fba.LAUNCHES
    batches = sum(math.ceil(n / svc.batch_size) for n, _, _ in requests)
    for imgs, (n, _, _) in zip(out, requests):
        check(imgs.dtype == np.uint8 and imgs.shape == (n, *shape), f"served {imgs.dtype} {imgs.shape}")
        check(imgs.std() > 1.0, "served images are flat")
    check(out[3].tobytes() == out[4].tobytes(), "the same seed gave different images")
    check(out[0].tobytes() != out[3][:64].tobytes(), "labels changed nothing")
    check(launches == 4 * batches, f"{launches} kernel launches for {batches} CGAN batches, "
                                   f"want {4 * batches}")
    check_moments("served CGAN requests", launches)
    # the first labelled batch, rendered from its z with the explicit one-hot
    gen = torch.Generator(device=dev).manual_seed(_request_seed(1, 0))
    z = torch.randn((BATCH, geo.z_dim), generator=gen, device=dev)
    lab = torch.tensor([SERVE_LABELS[i % len(SERVE_LABELS)] for i in range(BATCH)], device=dev)
    with torch.inference_mode():
        explicit = tanh_to_u8(svc.G(z, one_hot(lab, CGAN_CLASSES), svc.compute_dtype))
    check(explicit[:64].cpu().numpy().tobytes() == out[0].tobytes(),
          "a labelled batch differs from its z rendered with the explicit one-hot")
    print(f"CGAN served {' + '.join(str(n) for n, _, _ in requests)} images (labels "
          f"{SERVE_LABELS} on the first two requests, random classes on the rest) in {batches} "
          f"batches of {svc.batch_size}: {launches} kernel launches; the labelled batch equals "
          f"its z rendered with the explicit one-hot")
    return svc, launches


def phase_serve_vs_plain(svc, dev):
    """The service's uint8 output on one z (and, for CGAN, one set of
    classes) against the plain path on the card; then against the plain
    path with the plain sums (``plain_sums``), which shares no code with
    the moments kernels: within 1 LSB."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba

    g = torch.Generator(device=dev).manual_seed(123)
    z = torch.randn(BATCH, svc.geo.z_dim, generator=g, device=dev)
    args = (z, torch.randint(0, svc.num_classes, (BATCH,), generator=g, device=dev)) \
        if svc.conditional else (z,)
    what = "served CGAN uint8 images" if svc.conditional else "served uint8 images"
    check_u8_agree(lambda: svc.render(*args), what)
    got = svc.render(*args)
    with plain_sums():
        plain = with_bn_act(fba.bn_act_plain, lambda: svc.render(*args))
    diff = (got.int() - plain.int()).abs()
    exact = (diff == 0).float().mean().item()
    print(f"{what} vs the plain route with the plain sums: max diff {diff.max().item()} LSB, "
          f"{100 * exact:.4f} % exactly equal")
    check(diff.max().item() <= 1, f"{what} differ from the plain route with the plain sums by "
                                  f"more than 1 LSB")


def phase_timing(dev, card: str) -> dict:
    """Per G BN layer at batch 512, bf16, and at the fine-tune's largest
    BN map (bs128, 299²): the kernel's device time against its bound, its
    plain version, the wrapper (statistics + kernel), ``F.batch_norm`` +
    ReLU and the same function in two library calls; the kernel within one
    bf16 ulp (+ 1e-5) of its plain version on the first timed input of
    each. → G's four layers' totals and the largest |kernel - plain|."""
    import torch
    import torch.nn.functional as F

    from jckx_torch.kernels import fused_bn_act as fba

    g = torch.Generator(device=dev).manual_seed(1)
    c_ft, side_ft = FT_BN_SHAPES[0]
    shapes = [(BATCH, s, c, 1e-5) for s, c in G_LAYERS] + [(FT_BATCH, side_ft, c_ft, 1e-3)]
    rows_out, worst = [], 0.0
    for b, s, c, eps in shapes:
        rows = b * s * s
        nbytes = rows * c * 2
        xs = rotation(lambda: torch.randn(b, c, s, s, generator=g, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last), nbytes)
        scale = torch.rand(c, generator=g, device=dev) + 0.5
        bias = torch.randn(c, generator=g, device=dev)
        inv = torch.rand(c, generator=g, device=dev) + 0.5
        shift = torch.randn(c, generator=g, device=dev)
        x2ds = [(fba._rows(x), inv, shift) for x in xs]
        y = fba.normalize_act(*x2ds[0], "relu").float()
        ref = fba.normalize_act_plain(*x2ds[0], "relu").float()
        m = torch.maximum(y.abs(), ref.abs())
        ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7), torch.zeros_like(m))
        check(bool(((y - ref).abs() <= ulp + 1e-5).all()),
              f"the kernel at {b}x{s}x{s}x{c} bf16 differs from its plain version by more than "
              f"one bf16 ulp + 1e-5")
        worst = max(worst, (y - ref).abs().max().item())
        del y, ref, m, ulp
        ms = device_ms(lambda x, i, t: fba.normalize_act(x, i, t, "relu"), x2ds)
        plain = device_ms(lambda x, i, t: fba.normalize_act_plain(x, i, t, "relu"), x2ds)
        full = device_ms(lambda x: fba.bn_act(x, scale, bias, act="relu", eps=eps),
                         [(x,) for x in xs])
        lib = device_ms(lambda x: F.relu_(F.batch_norm(x, None, None, scale, bias, training=True,
                                                        eps=eps)), [(x,) for x in xs])
        lib2 = device_ms(_addcmul_relu, x2ds)
        moved = 2 * nbytes + 2 * c * 4           # x read, y written, inv + shift read
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = 3 * rows * c / F32_FLOPS_PER_S * 1e3  # FMA + activation, f32
        bound = max(bytes_ms, ops_ms)
        rows_out.append({"layer": f"{s}x{s}x{c}", "batch": b, "rows": rows, "C": c, "ms": ms,
                         "bound_ms": bound, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                         "plain_ms": plain, "bn_act_ms": full, "library_ms": lib,
                         "addcmul_relu_ms": lib2})
        print(f"  layer {s:>3}x{s:<3}x{c:<3} bs{b:<3} kernel {ms * 1e3:8.2f} us  bound "
              f"{bound * 1e3:6.2f} us ({100 * bound / ms:5.1f} %)  plain {plain * 1e3:8.2f} us  "
              f"bn_act (stats + kernel) {full * 1e3:8.2f} us  F.batch_norm + relu "
              f"{lib * 1e3:8.2f} us  the same function in two library calls (addcmul, relu_) "
              f"{lib2 * 1e3:8.2f} us   [{card}]")
        del xs, x2ds
    print("bn_act_layers " + json.dumps({"card": card, "dtype": "bfloat16", "layers": rows_out}))
    g_rows = rows_out[:len(G_LAYERS)]  # the fine-tune's map is no G layer
    out = {k: sum(r[k] for r in g_rows)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "addcmul_relu_ms")}
    print(f"per G forward at batch {BATCH}, bf16, the four BN layers: kernel {out['ms']:.5f} ms, "
          f"bound {out['bound_ms']:.5f} ms, plain {out['plain_ms']:.5f} ms, F.batch_norm + relu "
          f"{out['library_ms']:.5f} ms, addcmul + relu_ {out['addcmul_relu_ms']:.5f} ms; "
          f"max |kernel - plain| {worst} over these layers and the fine-tune's map   [{card}]")
    out["bound_by"] = "bytes" if all(r["bytes_ms"] >= r["ops_ms"] for r in g_rows) else "operations"
    out["max_abs_err"] = worst
    return out


def phase_moments(dev, card: str) -> dict:
    """The moments kernels (``fused_bn_act.bn_moments``) at G's four BN
    layers, batch 512, bf16: the largest error of their sums against f64
    (each relative to its channel's Σ|x| or Σx²) beside the plain route's,
    the same bits twice, and per layer the device time beside the bound
    (the activation read once at 3.35 TB/s), the plain route's time
    (``bn_moments_plain``) and that of one library reduction over the same
    bytes, ``torch.sum(x, 0, dtype=float32)``, which takes the sum alone.
    → the four layers' totals."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba

    def rel_err(sums, x):
        xd = x.double()
        ref = torch.stack([xd.sum(0), (xd * xd).sum(0)])
        scale = torch.stack([xd.abs().sum(0), (xd * xd).sum(0)]).clamp_min(1e-300)
        return ((sums.double() - ref).abs() / scale).max().item()

    g = torch.Generator(device=dev).manual_seed(2)
    rows_out = []
    for s, c in G_LAYERS:
        rows = BATCH * s * s
        nbytes = rows * c * 2
        xs = rotation(lambda: (torch.randn(rows, c, generator=g, device=dev) * 2 + 0.5).to(
            torch.bfloat16), nbytes)
        got = fba.bn_moments(xs[0])
        check(torch.equal(got, fba.bn_moments(xs[0])), f"moments at {rows}x{c}: two calls differ")
        err, err_plain = rel_err(got, xs[0]), rel_err(fba.bn_moments_plain(xs[0]), xs[0])
        check(err <= 2 * err_plain + 2.0 ** -24,
              f"moments at {rows}x{c}: error {err} against f64, the plain route's {err_plain}")
        ms = device_ms(fba.bn_moments, [(x,) for x in xs])
        plain = device_ms(fba.bn_moments_plain, [(x,) for x in xs])
        lib = device_ms(lambda x: torch.sum(x, 0, dtype=torch.float32), [(x,) for x in xs])
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows_out.append({"layer": f"{s}x{s}x{c}", "rows": rows, "C": c, "ms": ms, "bound_ms": bound,
                         "plain_ms": plain, "library_ms": lib, "rel_err_f64": err,
                         "plain_rel_err_f64": err_plain})
        print(f"  moments {s:>2}x{s:<2}x{c:<3} kernels {ms * 1e3:8.2f} us  bound {bound * 1e3:6.2f} us "
              f"({100 * bound / ms:5.1f} %)  plain {plain * 1e3:8.2f} us  torch.sum {lib * 1e3:8.2f} us"
              f"  error vs f64 {err:.3g} (plain {err_plain:.3g})   [{card}]")
    print("bn_moments_layers " + json.dumps({"card": card, "batch": BATCH, "dtype": "bfloat16",
                                             "layers": rows_out}))
    out = {k: sum(r[k] for r in rows_out) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    out["max_rel_err_f64"] = max(r["rel_err_f64"] for r in rows_out)
    print(f"per G forward at batch {BATCH}, bf16, the four BN layers' moments: kernels "
          f"{out['ms']:.5f} ms, bound {out['bound_ms']:.5f} ms "
          f"({100 * out['bound_ms'] / out['ms']:.1f} %), plain {out['plain_ms']:.5f} ms, "
          f"torch.sum {out['library_ms']:.5f} ms   [{card}]")
    out.update(_finetune_moments(dev, card, g, rel_err))
    return out


def _finetune_moments(dev, card: str, g, rel_err) -> dict:
    """The moments kernels at each distinct map of the fine-tune's 94 BN
    layers (bs128, 299², bf16; ``portbench/reference/inception.bn_maps``):
    their sums against f64 beside the plain route's, as ``phase_moments``
    holds G's, and each map's device time against its bound (x read once at
    3.35 TB/s) and the plain route's (the forward's sums before they took
    the kernels). → a step's kernels, bound and plain times (each map's
    times its count)."""
    import collections

    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from portbench.reference import inception as ref

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "portbench/configs/inception-v3-299.json")) as f:
        maps = ref.bn_maps(json.load(f), FT_BATCH)
    check(len(maps) == FT_CONVS, f"{len(maps)} fine-tune BN maps, want {FT_CONVS}")
    shapes = collections.Counter((n * h * w, c) for n, c, h, w in maps)
    step = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0}
    worst = 0.0
    for (rows, c), count in sorted(shapes.items(), key=lambda t: -t[0][0] * t[0][1]):
        nbytes = rows * c * 2
        xs = rotation(lambda: (torch.randn(rows, c, generator=g, device=dev) * 2 + 0.5).to(
            torch.bfloat16), nbytes)
        got = fba.bn_moments(xs[0])
        err, err_plain = rel_err(got, xs[0]), rel_err(fba.bn_moments_plain(xs[0]), xs[0])
        check(err <= 2 * err_plain + 2.0 ** -24,
              f"moments at {rows}x{c}: error {err} against f64, the plain route's {err_plain}")
        worst = max(worst, err)
        ms = device_ms(fba.bn_moments, [(x,) for x in xs])
        plain = device_ms(fba.bn_moments_plain, [(x,) for x in xs[:4]], iters=8)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for k, v in (("ms", ms), ("bound_ms", bound), ("plain_ms", plain)):
            step[k] += count * v
        print(f"  fine-tune moments {rows:>7}x{c:<4} x{count:<2} kernels {ms * 1e3:8.2f} us  bound "
              f"{bound * 1e3:6.2f} us ({100 * bound / ms:5.1f} %)  plain {plain * 1e3:8.2f} us  "
              f"error vs f64 {err:.3g} (plain {err_plain:.3g})   [{card}]")
        del xs
    print(f"per fine-tune step (bs128, 299², bf16), the 94 BN layers' moments: kernels "
          f"{step['ms']:.5f} ms, bound {step['bound_ms']:.5f} ms "
          f"({100 * step['bound_ms'] / step['ms']:.1f} %), plain {step['plain_ms']:.5f} ms; "
          f"largest error vs f64 {worst:.3g}   [{card}]")
    return {f"finetune_step_{k}": v for k, v in step.items()}


def phase_bwd_timing(dev, card: str) -> dict:
    """The fine-tune's BN + ReLU backward at ``FT_BN_SHAPES`` (bs128, 299²,
    bf16, a channels_last gradient): its kernels' device time (the sums
    with their combine, and dx) against the bound (x and the gradient read
    once, dx written once, at 3.35 TB/s), and the plain backward's
    (``bn_relu_bwd_sums_plain`` + ``bn_relu_bwd_dx_plain``, the route it
    replaced). → the largest map's (the first) times."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba

    g = torch.Generator(device=dev).manual_seed(4)
    rows_out = []
    for c, side in FT_BN_SHAPES:
        rows = FT_BATCH * side * side

        def make():
            x, grad = ((torch.randn(FT_BATCH, c, side, side, generator=g, device=dev) * 2 + 0.5)
                       .to(torch.bfloat16, memory_format=torch.channels_last) for _ in range(2))
            return x, grad, *(torch.randn(c, generator=g, device=dev) for _ in range(5))

        args = rotation(make, 2 * rows * c * 2)
        sums = device_ms(lambda x, gr, a, sh, *_: fba.bn_relu_bwd_sums(x, gr, a, sh), args)
        dx = device_ms(fba.bn_relu_bwd_dx, args)
        plain = device_ms(lambda x, gr, a, sh, m, g1, k: (
            fba.bn_relu_bwd_sums_plain(x, gr, a, sh),
            fba.bn_relu_bwd_dx_plain(x, gr, a, sh, m, g1, k)), args)
        bound = 3 * rows * c * 2 / HBM_BYTES_PER_S * 1e3
        rows_out.append({"layer": f"{side}x{side}x{c}", "batch": FT_BATCH, "rows": rows, "C": c,
                         "ms": sums + dx, "sums_ms": sums, "dx_ms": dx, "bound_ms": bound,
                         "plain_ms": plain})
        print(f"  BN + ReLU backward {side:>3}x{side:<3}x{c:<3} bs{FT_BATCH} kernels "
              f"{(sums + dx) * 1e3:8.2f} us (sums {sums * 1e3:.2f}, dx {dx * 1e3:.2f})  bound "
              f"{bound * 1e3:6.2f} us ({100 * bound / (sums + dx):5.1f} %)  plain "
              f"{plain * 1e3:8.2f} us   [{card}]")
        del args
    print("bn_relu_bwd_layers " + json.dumps({"card": card, "dtype": "bfloat16",
                                              "layers": rows_out}))
    return rows_out[0]


# BigGAN-128's ten conditional BN maps at ch 96, (side, channels, up): each
# block's two, the first writing its output upsampled x2; and its five
# residual sums, (channels, side of the shortcut s), y twice as wide
BIGGAN_BATCH = 256
BIGGAN_CBN_MAPS = [(4, 1536, 2), (8, 1536, 1), (8, 1536, 2), (16, 768, 1), (16, 768, 2),
                   (32, 384, 1), (32, 384, 2), (64, 192, 1), (64, 192, 2), (128, 96, 1)]
BIGGAN_SUMS = [(1536, 4), (768, 8), (384, 16), (192, 32), (96, 64)]


def biggan_replay_counts(dev) -> dict:
    """One served BigGAN-128 replay (ch 96, bs256, bf16, the benchmark's
    seeded weights written as a checkpoint): its kernels by name from the
    profiler, the counters zeroed just before (a window that falls short, a
    record the profiler dropped, is taken again, up to three times). → the
    launches of the conditional normalize, the residual sum, the
    per-channel normalize and the moments kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.serve import GeneratorService
    from portbench.reference import biggan as ref

    cfg = {"ch": 96, "image_size": 128, "channels": 3, "z_dim": 120, "z_chunks": 6,
           "shared_dim": 128, "num_classes": 1000, "attention": 64, "bn_eps": 1e-5}
    want = {"cbn_normalize": 10, "up2_add": 5, "bn_act": 1, "bn_moments": 22}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "biggan.pt")
        ref.write_checkpoint(path, ref.make_weights(cfg, 11, dev))
        svc = GeneratorService(path, batch_size=BIGGAN_BATCH)
    gen = torch.Generator(device=dev).manual_seed(5)
    z = torch.randn(BIGGAN_BATCH, 120, generator=gen, device=dev)
    labels = torch.randperm(1000, generator=gen, device=dev)[:BIGGAN_BATCH]
    svc.render(z, labels)  # eager, then the capture
    check(svc.program is not None, "the BigGAN service has no graphed program on the card")
    for _ in range(3):
        torch.cuda.synchronize()
        zero_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            svc.render(z, labels)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {word: sum(word in k for k in kernels) for word in want}
        if seen == want:
            break
    print(f"one served BigGAN-128 bs{BIGGAN_BATCH} replay, by the profiler: {seen}; counters: "
          f"normalize {fba.LAUNCHES}, moments {fba.MOMENTS_LAUNCHES}")
    check(seen == want, f"a BigGAN replay launched {seen}, want {want}")
    check((fba.LAUNCHES, fba.MOMENTS_LAUNCHES) == (1, 22),
          f"a BigGAN replay counted {fba.LAUNCHES} normalize and {fba.MOMENTS_LAUNCHES} moments "
          f"launches, want 1 and 22")
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return seen


def phase_biggan_kernels(dev, card: str) -> dict:
    """BigGAN-128's two kernels at bs256 bf16: the conditional normalize
    through ``cbn_act`` at G's ten conditional maps (up 1 and 2), bit for
    bit ``cbn_act_one_rounding`` (the same statistics kernels' sums) and
    channels_last, and the residual sum ``up2_add_`` at its five sums, bit
    for bit ``up2_add_plain_``, each on its first timed input; per map the
    kernel's device time (``cbn_normalize_act``, ``up2_add_``) beside its
    bound at 3.35 TB/s (the conditional one: x read, y written up² times,
    the (N, C) f32 scale and shift; the sum: y read and written, s read)
    and its plain version's; the launches of one served replay
    (``biggan_replay_counts``). → {"cbn_act": ..., "up2_add": ...}, each
    with its totals and launches."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.kernels import up2_add as u2

    cl, n = torch.channels_last, BIGGAN_BATCH
    g = torch.Generator(device=dev).manual_seed(6)
    rows_out = {"cbn_act": [], "up2_add": []}
    for side, c, up in BIGGAN_CBN_MAPS:
        def make():
            x = (torch.randn(n, c, side, side, generator=g, device=dev) * 2 + 0.5).to(
                torch.bfloat16, memory_format=cl)
            return x, torch.randn(n, c, generator=g, device=dev) + 1.0, torch.randn(
                n, c, generator=g, device=dev)

        args = rotation(make, n * side * side * c * 2 * (1 + up * up))
        x, scale, bias = args[0]
        with torch.no_grad():
            y = fba.cbn_act(x, scale, bias, up=up)
            same = torch.equal(y, fba.cbn_act_one_rounding(x, scale, bias, up=up))
        check(same and y.is_contiguous(memory_format=cl)
              and y.shape == (n, c, up * side, up * side),
              f"cbn_act at {side}x{side}x{c} up {up} bs{n} bf16 is not channels_last or differs "
              f"from cbn_act_one_rounding")
        del y
        rows = [(fba._rows(x), scale.abs() + 0.5, bias) for x, scale, bias in args]
        ms = device_ms(lambda x2d, i, t: fba.cbn_normalize_act(x2d, i, t, side, up), rows)
        plain = device_ms(lambda x2d, i, t: fba.cbn_normalize_act_plain(x2d, i, t, side, up),
                          rows)
        bound = ((1 + up * up) * n * side * side * c * 2 + 2 * n * c * 4) / HBM_BYTES_PER_S * 1e3
        rows_out["cbn_act"].append({"map": f"{side}x{side}x{c}", "up": up, "ms": ms,
                                    "bound_ms": bound, "plain_ms": plain})
        print(f"  cbn_normalize {side:>3}x{side:<3}x{c:<4} up {up} bs{n} kernel "
              f"{ms * 1e3:8.2f} us  bound {bound * 1e3:7.2f} us ({100 * bound / ms:5.1f} %)  plain "
              f"{plain * 1e3:8.2f} us   [{card}]")
        del args, rows
    for c, side in BIGGAN_SUMS:
        def make():
            return tuple(torch.randn(n, c, k * side, k * side, generator=g, device=dev).to(
                torch.bfloat16, memory_format=cl) for k in (2, 1))

        args = rotation(make, n * side * side * c * 2 * 9)
        y, s = args[0]
        want = y.clone()
        u2.up2_add_plain_(want, s)
        u2.up2_add_(y, s)
        check(torch.equal(y, want) and y.is_contiguous(memory_format=cl),
              f"up2_add_ at {2 * side}x{2 * side}x{c} bs{n} bf16 differs from up2_add_plain_")
        del want
        ms = device_ms(u2.up2_add_, args)
        plain = device_ms(u2.up2_add_plain_, args)
        bound = 9 * n * side * side * c * 2 / HBM_BYTES_PER_S * 1e3
        rows_out["up2_add"].append({"map": f"{2 * side}x{2 * side}x{c}", "ms": ms,
                                    "bound_ms": bound, "plain_ms": plain})
        print(f"  up2_add {2 * side:>3}x{2 * side:<3}x{c:<4} bs{n} kernel {ms * 1e3:8.2f} us  "
              f"bound {bound * 1e3:7.2f} us ({100 * bound / ms:5.1f} %)  plain (broadcast add) "
              f"{plain * 1e3:8.2f} us   [{card}]")
        del args
    print("biggan_layers " + json.dumps({"card": card, "batch": n, "dtype": "bfloat16",
                                         **rows_out}))
    seen = biggan_replay_counts(dev)
    out = {}
    for name, word in (("cbn_act", "cbn_normalize"), ("up2_add", "up2_add")):
        out[name] = {k: sum(r[k] for r in rows_out[name]) for k in ("ms", "bound_ms", "plain_ms")}
        out[name]["launches"] = seen[word]
        print(f"per BigGAN-128 render at batch {n}, bf16, {name}: kernels "
              f"{out[name]['ms']:.5f} ms, bound {out[name]['bound_ms']:.5f} ms "
              f"({100 * out[name]['bound_ms'] / out[name]['ms']:.1f} %), plain "
              f"{out[name]['plain_ms']:.5f} ms; {seen[word]} launches a replay   [{card}]")
    MOMENTS_ON_PATHS.append(seen["bn_moments"])
    out["bn_act_launches"] = seen["bn_act"]
    return out


def _addcmul_relu(x2d, inv, shift):
    """The kernel's function in two library calls: ``torch.addcmul(shift,
    x2d, inv)`` into a tensor of x's dtype (f32 arithmetic), then ``relu_``."""
    import torch

    return torch.addcmul(shift, x2d, inv, out=torch.empty_like(x2d)).relu_()


def phase_train_vs_cpu(dev, conditional: bool = False, fused_prop: int = 0) -> None:
    """One full-width train step (DCGAN, or CGAN with K = 100; the faithful
    step, or FusedProp with ``fused_prop``) on the card against the CPU,
    from the same weights, draws, masks and labels, in f32 with TF32 off
    (set in ``main``), cuDNN deterministic on the card: its default
    algorithms sum in an order that changes from run to run, and one
    masked element of CGAN's ``G.norm1.weight`` (499 masked, so none may
    flip) changed sign in 2 of 7 such runs on an H100, in none of 3 with
    deterministic algorithms. The GPU tests hold this step at 16², width 8,
    with no masked delta off; at full width on their draws two of CGAN's
    498 masked ``G.norm1.bias`` deltas differ by rounding on an H100, so the
    full-width step stays here, on its own draws and under its 0.1 % rule."""
    import torch

    from jckx_torch.configs import Config
    from jckx_torch.data.pipeline import one_hot
    from jckx_torch.models.cgan import HIDDEN, CDiscriminator, CGenerator
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.train.state import create_cgan_state, create_dcgan_state
    from jckx_torch.train.steps import (METRIC_NAMES, StepDraws, make_cgan_train_step,
                                        make_dcgan_train_step)

    cfg = Config()
    cfg.compute_dtype, cfg.max_learning_rate, cfg.batch_size = "float32", TRAIN_LR, 16
    cfg.fused_prop = fused_prop
    geo, n = GANGeometry(), 16
    g = torch.Generator().manual_seed(7)
    img = (n, geo.image_size, geo.image_size, geo.channels)
    draws = dict(real_noise=torch.randn(img, generator=g), z=torch.randn(n, geo.z_dim, generator=g),
                 fake_noise=torch.randn(img, generator=g), alpha=torch.rand(n, 1, 1, 1, generator=g))
    if conditional:
        for name in ("keep_real", "keep_fake", "keep_gp", "keep_g"):
            draws[name] = (torch.rand(n, HIDDEN, generator=g) < 0.75).float()
        onehot = one_hot(torch.randint(0, CGAN_CLASSES, (n,), generator=g), CGAN_CLASSES)
    real = torch.rand(img, generator=g) * 2 - 1
    out = []
    for device in (torch.device("cpu"), dev):
        gen = torch.Generator().manual_seed(0)
        if conditional:
            G, D = CGenerator(geo, CGAN_CLASSES, gen=gen), CDiscriminator(geo, CGAN_CLASSES, gen=gen)
            state = create_cgan_state(cfg, G.to(device), D.to(device))
            step = make_cgan_train_step(cfg, geo)
            extra = (onehot.to(device),)
        else:
            G, D = Generator(geo, gen=gen), Discriminator(geo, gen=gen)
            state = create_dcgan_state(cfg, G.to(device), D.to(device))
            step = make_dcgan_train_step(cfg, geo)
            extra = ()
        p0 = {**{"G." + k: v.detach().cpu().clone() for k, v in G.state_dict().items()},
              **{"D." + k: v.detach().cpu().clone() for k, v in D.state_dict().items()}}
        before = launch_counts()
        with _deterministic_cudnn():
            m = step(state, real.to(device), *extra,
                     StepDraws(**{k: v.to(device) for k, v in draws.items()}))
        check(launch_counts() == before,
              f"the differentiated train step on {device} launched a kernel")
        params = {**{"G." + k: v.detach().cpu() for k, v in G.state_dict().items()},
                  **{"D." + k: v.detach().cpu() for k, v in D.state_dict().items()}}
        grads = {**{"G." + k: q.grad.cpu() for k, q in G.named_parameters()},
                 **{"D." + k: q.grad.cpu() for k, q in D.named_parameters()}}
        out.append(({k: float(v) for k, v in m.items()}, params, grads))
    (mc, pc, gc), (mg, pg, _) = out
    worst = max(abs(mc[k] - mg[k]) for k in METRIC_NAMES)
    for k in METRIC_NAMES:
        check(math.isfinite(mg[k]) and abs(mc[k] - mg[k]) <= 3e-3 + 3e-3 * abs(mc[k]),
              f"train step card vs CPU: {k} {mg[k]} vs {mc[k]}")
    check(not fused_prop or (mg["d_gz1"] == mg["d_gz2"] and mc["d_gz1"] == mc["d_gz2"]),
          "FusedProp: d_gz2 differs from d_gz1")
    # At full width the f32 gradient of G's middle convolutions carries
    # rounding error up to ~5 % of the leaf's maximum (cancellation through
    # batch-statistic BN; f32 against f64 on the CPU flips 8 of 497,890
    # masked elements of G.conv3.weight). So up to 0.1 % of a leaf's masked
    # elements may disagree; a wiring fault moves whole fractions of a leaf.
    total = covered = flipped = 0
    for k, g_cpu in gc.items():
        d_card, d_cpu = pg[k] - p0[k], pc[k] - p0[k]
        check(d_card.abs().max() <= 1.01 * TRAIN_LR and d_cpu.abs().max() <= 1.01 * TRAIN_LR,
              f"{k}: an Adam step-1 delta exceeds lr")
        mask = g_cpu.abs() > 1e-2 * g_cpu.abs().max() + 1e-12
        bad = int(((d_card - d_cpu).abs() > 0.05 * TRAIN_LR)[mask].sum())
        total += mask.numel()
        covered += int(mask.sum())
        flipped += bad
        check(bad <= 1e-3 * int(mask.sum()),
              f"{k}: {bad} of {int(mask.sum())} masked Adam deltas card vs CPU differ by > 5 % of lr")
    check(covered / total > 0.5, f"the gradient mask covers {covered}/{total} elements")
    print(f"{'CGAN (K 100)' if conditional else 'DCGAN'}{' FusedProp' if fused_prop else ''} "
          f"train step card vs CPU (64², z 100, "
          f"width 64, batch {n}, f32, TF32 off): telemetry max "
          f"|diff| {worst:.3g} (<= 3e-3); Adam deltas within {0.05 * TRAIN_LR:g} on "
          f"{covered - flipped} of {covered} masked elements ({100 * covered / total:.1f} % of the "
          f"parameters); 0 kernel launches"
          + ("; d_gz2 == d_gz1 on both" if fused_prop else ""))


def _run_dir_args(tmp: str, model: str, run: str = "") -> list:
    return ["--save_root", os.path.join(tmp, "save"), "--data_dir", os.path.join(tmp, "data"),
            "-pm", run or f"smoke_{model.lower()}"]


def phase_train(tmp: str, model: str = "DCGAN", flags: tuple = (), run: str = ""):
    """The main training path through the entry point, for ``model``, with
    the train flags ``flags`` in run dir ``run``. → (trainer, its eval
    records, kernel launches during the run)."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.serve import tanh_to_u8
    from jckx_torch.train import main as tmain

    where = _run_dir_args(tmp, model, run)
    argv = ["-m", model, "--dataset", "synthetic", "-b", str(TRAIN_BATCH), "-e", "1",
            "-mlr", str(TRAIN_LR), "--log_every", "8", "--eval_every", "16"] + list(flags) + where
    zero_launches()
    tr = tmain.main(argv)
    torch.cuda.synchronize()
    launches = fba.LAUNCHES
    MainLogger.reset()
    conditional = model == "CGAN"
    check(tr.conditional == conditional and tr.device.type == "cuda" and tr.cd == torch.bfloat16
          and tr.n_data == 4096, f"{model} trainer on {tr.device} in {tr.cd} over {tr.n_data} rows")
    check(tr.state.step == 32 and tr.evals == [8, 16, 32], f"step {tr.state.step}, evals {tr.evals}")
    # one G forward per eval for DCGAN; CGAN samples 10 x K rows in chunks of 500
    n_eval = CGAN_CLASSES * 10 if conditional else EVAL_BATCH
    forwards = math.ceil(n_eval / CGAN_CHUNK) if conditional else 1
    per_eval = tr.geo.n_up * forwards
    check(tr.eval_z.shape[0] == n_eval, f"{tr.eval_z.shape[0]} eval rows, want {n_eval}")
    check(launches == per_eval * len(tr.evals),
          f"{launches} kernel launches for {len(tr.evals)} evals; want {per_eval} each "
          f"and none from the 32 train steps")
    check_moments(f"{model} trainer's evals", launches)
    with open(os.path.join(tr.save_path, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    evals = [r for r in records if "fid" in r]
    metrics = ("fid", "is", "intra_fid") if conditional else ("fid", "is")
    losses = [v for pair in tr._resumed_losses for v in pair]
    check(len(losses) == 64 and all(math.isfinite(v) for v in losses), "losses not finite")
    check(all(math.isfinite(r[k]) for r in evals for k in metrics), f"{metrics} not all finite")
    for rel in ("latest.ckpt", "real_image.png", "loss.png", "config.json") + tuple(
            f"img/{it}_fake_image.png" for it in (tr.evals if conditional else ())):
        check(os.path.isfile(os.path.join(tr.save_path, rel)), f"{rel} missing")
    for typ in metrics:
        names = os.listdir(os.path.join(tr.save_path, typ))
        check(any(f.endswith(".pt") for f in names) and any(f.endswith("_fake_image.png") for f in names),
              f"{typ}/ lacks a checkpoint or a grid")
    print(f"{model}{' ' + ' '.join(flags) if flags else ''}: trained 32 steps at batch "
          f"{TRAIN_BATCH}, bf16, through jckx_torch.train.main: evals after {tr.evals}, "
          f"{launches} kernel launches = {per_eval} per eval ({forwards} G forward(s) "
          f"of {min(n_eval, CGAN_CHUNK) if conditional else n_eval} rows), 0 from the steps; last "
          f"losses D {tr._resumed_losses[-1][0]:.4f} G {tr._resumed_losses[-1][1]:.4f}; "
          + ", ".join(" ".join(f"{k} {r[k]:.4f}" for k in metrics) + f" @ {r['step']}" for r in evals))
    # the kernel at the eval's shapes, on the trained weights, against the plain route
    check(tr.cfg.sample_count == EVAL_BATCH, f"sample_count {tr.cfg.sample_count}")
    before = fba.LAUNCHES
    check_u8_agree(lambda: tanh_to_u8(tr.sample_eval()),
                   f"{model} eval sample of {n_eval} trained images (uint8)")
    check(fba.LAUNCHES == before + per_eval, "the eval sample did not launch the kernel")

    before = launch_counts()
    tr2 = tmain.main(["--resume"] + where)
    MainLogger.reset()
    check(tr2.conditional == conditional and tr2.state.step == 32 and tr2.evals == []
          and launch_counts() == before,
          f"--resume started at step {tr2.state.step} and evaluated {tr2.evals}")
    print(f"{model} --resume on the same run dir: restored step 32, nothing left to train")
    return tr, evals, launches


def phase_evaluate(tr, evals, tmp: str) -> int:
    """``evaluate`` on the CGAN run's ``intra_fid/`` best checkpoint and
    ``-t 1`` on its ``latest.ckpt``, against the FID / IS / intra-FID the
    run logged at those steps: within 1 % relative (a fresh engine may
    round bf16 features otherwise). → their kernel launches."""
    from jckx_torch import evaluate
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.train import main as tmain

    where = _run_dir_args(tmp, "CGAN")
    logged = {r["step"]: r for r in evals}
    sub = os.path.join(tr.save_path, "intra_fid")
    (pt,) = [f for f in os.listdir(sub) if f.endswith(".pt")]
    zero_launches()
    scored = [evaluate.main(["--ckpt", os.path.join(sub, pt), "--dataset", "synthetic"] + where[:4])]
    launches = [fba.LAUNCHES]
    check_moments(f"evaluate intra_fid/{pt}", launches[0])
    MainLogger.reset()
    zero_launches()
    scored.append(tmain.main(["-t", "1"] + where))
    launches.append(fba.LAUNCHES)
    check_moments("-t 1 on latest.ckpt", launches[1])
    MainLogger.reset()
    for what, res, n in zip((f"evaluate intra_fid/{pt}", "-t 1 on latest.ckpt"), scored, launches):
        ref = logged.get(res["step"])
        check(ref is not None, f"{what}: step {res['step']} was not evaluated in the run")
        check(n == 8 and res["n"] == 10 * CGAN_CLASSES, f"{what}: {n} launches, {res['n']} samples")
        gaps = {k: abs(res[k] - ref[k]) / abs(ref[k]) for k in ("fid", "is", "intra_fid")}
        check(all(g <= 0.01 for g in gaps.values()), f"{what}: {res} against logged {ref}")
        print(f"{what}: step {res['step']}, {n} kernel launches; relative gap to the logged eval "
              + ", ".join(f"{k} {g:.3g}" for k, g in gaps.items()) + " (<= 0.01)")
    return sum(launches)








def phase_serve_modes(path: str, cgan_path: str, svc, dev) -> int:
    """int8 (DCGAN and CGAN with labels), sub-pixel and truncated serving,
    and interpolation, with the launch counter reset just before the
    requests and read just after. → kernel launches."""
    import numpy as np
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.serve import GeneratorService, interpolation_latents

    q = GeneratorService(path, quant="int8")
    cq = GeneratorService(cgan_path, quant="int8")
    sub = GeneratorService(path, subpixel=True)
    trunc = GeneratorService(path, truncation=0.7)
    check(q.params["convt0_q"].dtype == torch.int8 and cq.params["convt0_q"].shape[0] == 200,
          "int8 params")
    requests = [(q, 64, None, 1), (q, 1000, None, None), (cq, 64, SERVE_LABELS, 1),
                (cq, 600, None, None), (sub, 64, None, 1), (sub, 1000, None, None),
                (trunc, 64, None, 1), (trunc, 64, None, 1)]
    zero_launches()
    out = [s.sample(n, labels=lab, seed=seed) for s, n, lab, seed in requests]
    walks = [trunc.interpolate(3, 5, steps=16), trunc.interpolate(3, 5, steps=16),
             cq.interpolate(3, 5, steps=16, label_a=3, label_b=17)]
    launches = fba.LAUNCHES
    batches = sum(math.ceil(n / BATCH) for _, n, _, _ in requests) + len(walks)
    check(launches == 4 * batches, f"{launches} kernel launches for {batches} batches of the "
                                   f"int8, sub-pixel and truncated samplers, want {4 * batches}")
    check_moments("the int8, sub-pixel and truncated samplers", launches)
    shape = (svc.geo.image_size, svc.geo.image_size, svc.geo.channels)
    for imgs, (_, n, _, _) in zip(out, requests):
        check(imgs.dtype == np.uint8 and imgs.shape == (n, *shape) and imgs.std() > 1.0,
              f"served {imgs.dtype} {imgs.shape}")
    check(out[6].tobytes() == out[7].tobytes(), "a truncated request is not deterministic")
    g = torch.Generator(device=dev).manual_seed(5)
    z = trunc.draw_z(g, (BATCH, svc.geo.z_dim))
    check(float(z.abs().max()) <= 0.7 and float(z.std()) > 0.3, "truncated z outside [-0.7, 0.7]")
    check(walks[0].tobytes() == walks[1].tobytes(), "interpolate is not byte-identical across calls")
    t = torch.linspace(0, 1, 16, device=dev)
    z = interpolation_latents(trunc.endpoint_z(3), trunc.endpoint_z(5), t)
    check(trunc.render_latents(z).cpu().numpy().tobytes() == walks[0].tobytes(),
          "an interpolated strip differs from the render of its latents")
    eye = torch.eye(CGAN_CLASSES, device=dev)
    onehot = (1 - t[:, None]) * eye[3] + t[:, None] * eye[17]
    z = interpolation_latents(cq.endpoint_z(3), cq.endpoint_z(5), t)
    check(cq.render_latents(z, onehot).cpu().numpy().tobytes() == walks[2].tobytes(),
          "the int8 CGAN strip differs from the render of its latents")
    print(f"int8 (DCGAN; CGAN with labels {SERVE_LABELS}), sub-pixel and truncated (t 0.7) serving: "
          f"{len(requests)} requests and 3 interpolation strips of 16 in {batches} batches, "
          f"{launches} kernel launches; truncated z within [-0.7, 0.7]; strips byte-identical across "
          f"calls and equal to the render of their latents")
    # the uint8 renders against the plain routes on one z (int8: the f32 kernel variant)
    g = torch.Generator(device=dev).manual_seed(123)
    z = torch.randn(BATCH, svc.geo.z_dim, generator=g, device=dev)
    lab = torch.randint(0, CGAN_CLASSES, (BATCH,), generator=g, device=dev)
    # int8: a one-ulp f32 difference that straddles a quantization boundary
    # flips an int8 activation by one step, which moves the next layer's
    # int32 sums by whole weights: several LSB on a few pixels (measured on
    # an H100: max 3 LSB, 99.7803 % exact for seed-0 DCGAN). The flips are
    # counted; the bit-identity with the once-rounded route is the check.
    for svc_q, args, what in ((q, (z,), "int8 DCGAN"), (cq, (z, lab), "int8 CGAN")):
        flips = count_int8_flips(lambda: svc_q.render(*args))
        print(f"{what}: int8 activations that differ between the kernel and the plain route, "
              f"by layer: {flips}")
        check_u8_agree(lambda: svc_q.render(*args), f"{what} uint8 images", max_lsb=4,
                       min_exact=0.99)
    check_u8_agree(lambda: sub.render(z), "sub-pixel uint8 images (bf16)")
    # the sub-pixel form against the default one on the same z
    diff = (sub.render(z).int() - svc.render(z).int()).abs()
    print(f"sub-pixel vs default sampler, bf16, same z: max diff {diff.max().item()} LSB, "
          f"{100 * (diff == 0).float().mean().item():.4f} % exactly equal, mean "
          f"{diff.float().mean().item():.4f} LSB")
    f32 = [GeneratorService(path, compute_dtype=torch.float32, subpixel=s).render(z) for s in (False, True)]
    diff = (f32[0].int() - f32[1].int()).abs()
    print(f"sub-pixel vs default sampler, f32 (TF32 off), same z: max diff {diff.max().item()} LSB, "
          f"{100 * (diff == 0).float().mean().item():.4f} % exactly equal")
    check(diff.max().item() <= 1, "f32 sub-pixel sampler differs from the default by more than 1 LSB "
                                  "(tests/test_serve.py:67-78)")
    return launches


def count_int8_flips(render) -> list:
    """Per quantized layer of ``render()``'s int8 forward, the int8
    activations that differ between the kernel route and ``bn_act_plain``
    (``(flipped, total)``)."""
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.ops import quant as tquant

    real = tquant.quantize_act
    runs = []

    def record(x, scale):
        q = real(x, scale)
        runs[-1].append(q)
        return q

    tquant.quantize_act = record
    try:
        runs.append([])
        with programs_eager():  # a replay would record nothing
            render()
        runs.append([])
        with_bn_act(fba.bn_act_plain, render)
    finally:
        tquant.quantize_act = real
    return [(int((a != b).sum()), a.numel()) for a, b in zip(*runs)]


def _http(port: int, path: str, body=None):
    """→ (status, content type, body) of one request to 127.0.0.1:port."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


class Daemon:
    """``make_http_server`` on 127.0.0.1:0, in a thread of this process."""

    def __init__(self, svc):
        import threading

        from jckx_torch.serve import make_http_server

        self.srv = make_http_server(svc, "127.0.0.1", 0)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def __call__(self, path: str, body=None):
        return _http(self.port, path, body)

    def metrics(self) -> dict:
        body = self("/metrics")[2].decode()
        return {k: float(v) for k, v in (ln.split() for ln in body.splitlines()
                                         if ln and not ln.startswith("#"))}

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)


def _npy(body: bytes):
    import io

    import numpy as np

    return np.load(io.BytesIO(body))


def phase_http(svc, csvc) -> int:
    """The HTTP daemon on the card, in this process. → kernel launches."""
    import struct

    from jckx_torch.kernels import fused_bn_act as fba

    d = Daemon(svc)
    try:
        zero_launches()
        code, ctype, body = d("/healthz")
        health = json.loads(body)
        check(code == 200 and health["status"] == "ok" and health["batch_size"] == BATCH
              and health["image_size"] == svc.geo.image_size, f"/healthz {code} {body[:200]}")
        code, _, body = d("/generate", {"n": 600, "seed": 5, "format": "npy"})
        check(code == 200 and body and _npy(body).tobytes() == svc.sample(600, seed=5).tobytes(),
              "/generate npy differs from sample() with the same seed")
        code, ctype, png = d("/generate", {"n": 64})
        side = 8 * (svc.geo.image_size + 2) + 2  # make_grid: 8 columns, 2 px padding
        check(code == 200 and ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
              and struct.unpack(">II", png[16:24]) == (side, side), f"/generate png {code} {ctype}")
        code, _, body = d("/interpolate", {"seed_a": 1, "seed_b": 2, "steps": 8, "format": "npy"})
        check(code == 200 and _npy(body).tobytes() == svc.interpolate(1, 2, steps=8).tobytes(),
              "/interpolate differs from interpolate()")
        bad = [{"n": 0}, {"n": 5000}, {"labels": [1]}, {"format": "jpeg"}]
        for b in bad:
            code, _, body = d("/generate", b)
            check(code == 400 and "error" in json.loads(body), f"/generate {b}: {code}")
        check(d("/nope")[0] == 404, "GET /nope is not a 404")
        m = d.metrics()
        want = {"jckx_generate_requests_total": 3 + len(bad), "jckx_generate_images_total": 600 + 64 + 8,
                "jckx_generate_errors_total": len(bad), "jckx_serving_batch_size": BATCH,
                "jckx_checkpoint_step": svc.step}
        check(all(m[k] == v for k, v in want.items()), f"/metrics {m} want {want}")
        # a request at the daemon's cap (npy body, 48 MiB)
        code, _, body = d("/generate", {"n": 4096, "seed": 100, "format": "npy"})
        check(code == 200 and _npy(body).shape[0] == 4096, "/generate of 4096")
    finally:
        d.close()
    c = Daemon(csvc)
    try:
        code, _, body = c("/generate", {"n": 600, "labels": SERVE_LABELS, "seed": 2, "format": "npy"})
        check(code == 200 and _npy(body).tobytes()
              == csvc.sample(600, labels=SERVE_LABELS, seed=2).tobytes(),
              "CGAN /generate with labels differs from sample()")
        for b in ({"n": 2, "labels": [CGAN_CLASSES]}, {"n": 2, "labels": []}):
            check(c("/generate", b)[0] == 400, f"CGAN /generate {b} is not a 400")
        check(c("/interpolate", {"seed_a": 1, "seed_b": 2})[0] == 400, "CGAN walk without label_a")
    finally:
        c.close()
    launches = fba.LAUNCHES
    # the daemon's renders, and the sample() / interpolate() calls they are held against
    batches = 2 * 2 + 1 + 2 * 1 + 8 + 2 * 2
    check(launches == 4 * batches, f"{launches} kernel launches in the HTTP phase, want {4 * batches}")
    check_moments("the HTTP phase", launches)
    print(f"HTTP daemon on the card: /healthz, /generate npy (== sample()), png ({side}x{side}), "
          f"/interpolate (== interpolate()), /metrics counters, the 400s and a 404, a request of "
          f"4096, CGAN labels; {launches} kernel launches")
    return launches


def phase_watch(step8: str, latest: str, tmp: str) -> int:
    """``--watch``: a daemon on a copy of the DCGAN run's step-8 checkpoint;
    the copy is replaced atomically with the run's final ``latest.ckpt``,
    and one poll swaps the service. → kernel launches."""
    import shutil

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.serve import CheckpointWatcher, GeneratorService

    watched = os.path.join(tmp, "watch", "latest.ckpt")
    os.makedirs(os.path.dirname(watched), exist_ok=True)
    shutil.copy(step8, watched)
    os.utime(watched, ns=(8 * 10**9, 8 * 10**9))
    d = Daemon(GeneratorService(watched))
    watcher = CheckpointWatcher(d.srv, watched, lambda: GeneratorService(watched))
    zero_launches()
    try:
        check(json.loads(d("/healthz")[2])["step"] == 8, "the watched daemon does not serve step 8")
        check(watcher.poll_once() is False, "a swap without a change")
        before = d("/generate", {"n": 64, "seed": 3, "format": "npy"})[2]
        shutil.copy(latest, watched + ".tmp")
        os.replace(watched + ".tmp", watched)
        os.utime(watched, ns=(32 * 10**9, 32 * 10**9))
        check(watcher.poll_once() is True, "the watcher did not swap the replaced checkpoint")
        step = json.loads(d("/healthz")[2])["step"]
        after = d("/generate", {"n": 64, "seed": 3, "format": "npy"})[2]
    finally:
        d.close()
    fresh = GeneratorService(watched).sample(64, seed=3)
    launches = fba.LAUNCHES
    check(step == 32, f"/healthz reads step {step} after the swap, want 32")
    check(_npy(after).tobytes() == fresh.tobytes() and after != before,
          "after the swap /generate differs from a fresh service on the new file")
    check(launches == 4 * 3, f"{launches} kernel launches in the watch phase, want 12")
    check_moments("the watch phase", launches)
    print(f"--watch: a daemon on the DCGAN run's step-8 checkpoint swapped to its final latest.ckpt "
          f"on one poll: /healthz step 8 -> {step}, /generate equals a fresh service on the new "
          f"file; {launches} kernel launches")
    return launches


def phase_evaluate_int8(tr, tmp: str) -> int:
    """``evaluate --quant int8`` on the CGAN run's ``latest.ckpt``: 8
    launches, and the int8 params it scores equal those served with the
    same calibration seed. → kernel launches."""
    import torch

    from jckx_torch import evaluate
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.serve import GeneratorService

    latest = os.path.join(tr.save_path, "latest.ckpt")
    scored = []
    real = evaluate.make_sampler

    def spy(G, **kw):
        params, apply = real(G, **kw)
        scored.append(params)
        return params, apply

    evaluate.make_sampler = spy
    zero_launches()
    try:
        res = evaluate.main(["--ckpt", latest, "--dataset", "synthetic", "--quant", "int8",
                             "--calib_seed", "3"] + _run_dir_args(tmp, "CGAN")[:4])
    finally:
        evaluate.make_sampler = real
    launches, moments = launch_counts()
    MainLogger.reset()
    served = GeneratorService(latest, quant="int8", seed=3).params
    check(launches == 8 and res["quant"] == "int8" and res["n"] == 10 * CGAN_CLASSES,
          f"evaluate --quant int8: {launches} launches, {res}")
    check_moments("evaluate --quant int8", launches, moments)
    check(all(math.isfinite(res[k]) for k in ("fid", "is", "intra_fid")), f"{res}")
    (params,) = scored
    check(set(params) == set(served) and all(
        params[k].dtype == served[k].dtype and torch.equal(params[k], served[k]) for k in served),
        "the int8 params evaluate scores differ from the served ones")
    print(f"evaluate --quant int8 --calib_seed 3 on the CGAN run's latest.ckpt (step {res['step']}): "
          f"{launches} kernel launches, fid {res['fid']:.4f} is {res['is']:.4f} intra_fid "
          f"{res['intra_fid']:.4f}; the scored int8 params equal serve --quant int8 --seed 3's, "
          f"bit for bit")
    return launches






def phase_export(path: str, cgan_path: str, tmp: str, dev) -> int:
    """Sealed artifacts exported on the card from the seed-0 checkpoints,
    each loaded in a fresh ``ArtifactService``, the launch counter reset
    just before each artifact request and read just after; one
    ``/generate`` through the daemon over the DCGAN ``.pt2``. → kernel
    launches."""
    import numpy as np
    import torch

    from jckx_torch import rng
    from jckx_torch.export import ArtifactService, export_generator
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.serve import GeneratorService

    labels = [SERVE_LABELS[i % len(SERVE_LABELS)] for i in range(EXPORT_BATCH)]
    lab_dev = torch.tensor(labels, device=dev)
    arts, launches = {}, 0
    for what, src, quant, cond in (("dcgan_bf16", path, None, False),
                                   ("cgan_bf16", cgan_path, None, True),
                                   ("dcgan_int8", path, "int8", False)):
        dst = os.path.join(tmp, f"{what}.pt2")
        info = export_generator(src, dst, quant=quant)  # the defaults: cuda, batch 64, bf16
        check(info["platforms"] == ["cuda"] and info["batch_size"] == EXPORT_BATCH
              and info["conditional"] == cond and info["quant"] == quant, f"{what}: {info}")
        art = arts[what] = ArtifactService(dst)
        ref = GeneratorService(src, batch_size=EXPORT_BATCH, quant=quant)
        exact, worst = [], 0
        for seed in (0, 1, 7):
            zero_launches()
            got = art.sample(EXPORT_BATCH, labels=labels if cond else None, seed=seed)
            n = fba.LAUNCHES
            check(n == 4, f"{what}: {n} kernel launches for one batch of the artifact, want 4")
            check_moments(f"{what} seed {seed}", n)
            launches += n
            z = rng.normal_from_seed(seed, (EXPORT_BATCH, ref.geo.z_dim), device=dev)
            args = (z, lab_dev) if cond else (z,)
            check(got.tobytes() == ref.render(*args).cpu().numpy().tobytes(),
                  f"{what}: the artifact's render of seed {seed} differs from the service's")
            plain = with_bn_act(fba.bn_act_plain, lambda: ref.render(*args)).cpu().numpy()
            diff = np.abs(got.astype(np.int16) - plain.astype(np.int16))
            worst = max(worst, int(diff.max()))
            exact.append(float((diff == 0).mean()))
            if quant:
                print(f"{what} seed {seed} at batch {EXPORT_BATCH}: int8 activations that differ "
                      f"between the kernel and the plain route, by layer: "
                      f"{count_int8_flips(lambda: ref.render(*args))}")
            ok = (diff.max() <= 4 and exact[-1] >= INT8_EXACT_BS64) if quant else diff.max() <= 1
            check(ok, f"{what}: seed {seed} vs the plain route: max {diff.max()} LSB, "
                      f"{100 * exact[-1]:.4f} % exactly equal")
        shape = (100, ref.geo.image_size, ref.geo.image_size, ref.geo.channels)
        check(art.sample(100).shape == shape, f"{what}: a request of 100")
        print(f"artifact {what} (batch {EXPORT_BATCH}, {info['bytes']} bytes): seeds 0, 1, 7: 4 "
              f"kernel launches each, bit-identical to the service on rng.normal_from_seed's z; vs "
              f"the plain route max {worst} LSB, {100 * min(exact):.4f} % exactly equal")
    d = Daemon(arts["dcgan_bf16"])
    try:
        code, _, body = d("/healthz")
        check(code == 200 and json.loads(body)["batch_size"] == EXPORT_BATCH, f"/healthz {code}")
        zero_launches()
        code, _, body = d("/generate", {"n": 600, "seed": 5, "format": "npy"})
        n = fba.LAUNCHES
        want = 4 * math.ceil(600 / EXPORT_BATCH)
        check(n == want, f"/generate of 600 over a .pt2: {n} kernel launches, want {want}")
        check_moments("/generate of 600 over a .pt2", n)
        launches += n
        check(code == 200 and _npy(body).tobytes()
              == arts["dcgan_bf16"].sample(600, seed=5).tobytes(),
              "/generate over a .pt2 differs from the artifact's sample()")
        check(d("/interpolate", {"seed_a": 1, "seed_b": 2})[0] == 400,
              "/interpolate over a .pt2 is not a 400")
    finally:
        d.close()
    print(f"/generate over the DCGAN .pt2: 600 npy equal to sample(), {want} kernel launches, "
          f"/interpolate a 400")
    return launches


def _cli(args, env=None, timeout: float = 600):
    """``python -m jckx_torch <args>`` from the checkout → CompletedProcess."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.run([sys.executable, "-m", "jckx_torch", *args], cwd=here, env=env,
                          capture_output=True, text=True, timeout=timeout)


def phase_tools(path: str, pt2: str, tmp: str, kind: str) -> None:
    """``convert``, ``inspect`` and ``doctor`` through the front door, each
    command a process of its own, the independent ones at once."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    ckpt, back = os.path.join(tmp, "tools", "run.ckpt"), os.path.join(tmp, "tools", "back.pt")
    jaxexp = os.path.join(tmp, "tools", "g.jaxexp")
    os.makedirs(os.path.dirname(jaxexp), exist_ok=True)
    with open(jaxexp, "wb") as f:
        f.write(b"StableHLO program bytes")
    with open(jaxexp + ".json", "w") as f:
        json.dump({"batch_size": 64, "conditional": False, "num_classes": None, "z_dim": 100,
                   "image_size": 64, "channels": 3, "base_width": 64,
                   "platforms": ["cpu", "tpu"], "quant": None}, f)
    no_card = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    targets = [(path, "reference"), (ckpt, "jckx_torch checkpoint"), (pt2, "torch.export"),
               (jaxexp, "StableHLO")]
    with ThreadPoolExecutor(len(targets) + 1) as pool:
        doctor = pool.submit(_cli, ["doctor"], None, 600)
        inspected = {f: pool.submit(_cli, ["inspect", "--ckpt", f], no_card)
                     for f, _ in targets if f != ckpt}
        for src, dst, extra in ((path, ckpt, ["--with_ema"]), (ckpt, back, [])):
            out = _cli(["convert", "--src", src, "--dst", dst] + extra)
            check(out.returncode == 0, f"convert {src} -> {dst}: {out.stderr[-2000:]}")
            if dst == ckpt:
                inspected[ckpt] = pool.submit(_cli, ["inspect", "--ckpt", ckpt], no_card)
        orig, mid, last = (torch.load(f, map_location="cpu", weights_only=True)
                           for f in (path, ckpt, back))
        for key in ("model_g", "model_d"):
            check(all(torch.equal(orig[key][k], last[key][k]) for k in orig[key]),
                  f"convert round trip changed {key}")
        check(all(torch.equal(mid["ema_g"][k], orig["model_g"][k]) for k in orig["model_g"]),
              "--with_ema did not seed ema_g with G")
        kinds = []
        for f, want in targets:
            out = inspected[f].result()
            check(out.returncode == 0, f"inspect {f}: {out.stderr[-2000:]}")
            info = json.loads(out.stdout)
            check(want in info["kind"] and info["file_bytes"] == os.path.getsize(f),
                  f"inspect {info}")
            check("params_g" not in info or info["params_g"] == 3_576_704, f"inspect {info}")
            kinds.append(info["kind"])
        out = doctor.result()
    report = json.loads(out.stdout) if out.stdout.strip().startswith("{") else {}
    check(out.returncode == 0 and report.get("ok") and report["backend"]["device_kind"] == kind
          and report["kernel"]["ok"], f"doctor exited {out.returncode}: {out.stdout[-2000:]}")
    print(f"convert .pt -> checkpoint (--with_ema) -> .pt: equal tensors; inspect (no card "
          f"visible) read {kinds}; doctor exited 0: {report['backend']['nvidia_smi']}, kernel "
          f"max |err| {report['kernel']['max_abs_err_vs_plain']}, build "
          f"{report['kernel']['build_s']} s, link read {report['link'].get('read_s')} s, "
          f"toolchain {report['toolchain']}")


def kid_f64(real, fake, perms, m: int, degree: int = 3, coef0: float = 1.0):
    """KID's mean and std in float64 numpy on the given subset draws."""
    import numpy as np

    real, fake = np.asarray(real, np.float64), np.asarray(fake, np.float64)
    g = 1.0 / real.shape[1]
    vals = []
    for pr, pf in perms:
        x, y = real[np.asarray(pr)[:m]], fake[np.asarray(pf)[:m]]
        kxx, kyy = (g * x @ x.T + coef0) ** degree, (g * y @ y.T + coef0) ** degree
        kxy = (g * x @ y.T + coef0) ** degree
        vals.append((kxx.sum() - np.trace(kxx) + kyy.sum() - np.trace(kyy)) / (m * (m - 1))
                    - 2.0 * kxy.mean())
    return float(np.mean(vals)), float(np.std(vals))


def prdc_f64(real, fake, k: int = 3) -> dict:
    """Precision / recall / density / coverage in float64 numpy, directly."""
    import numpy as np

    real, fake = np.asarray(real, np.float64), np.asarray(fake, np.float64)

    def dmat(a, b):
        return np.sqrt(np.maximum((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
                                  - 2.0 * a @ b.T, 0.0))

    r_r, r_f = np.sort(dmat(real, real), 1)[:, k], np.sort(dmat(fake, fake), 1)[:, k]
    d = dmat(fake, real)
    hit = d <= r_r[None, :]
    return {"precision": float(hit.any(1).mean()), "recall": float((d.T <= r_f).any(1).mean()),
            "density": float(hit.sum(1).mean() / k), "coverage": float((d.min(0) <= r_r).mean())}


def phase_extra_metrics(tr, tmp: str, dev) -> int:
    """``evaluate --kid 1 --prdc 1 --eval_fast_stem 1`` on the CGAN run's
    ``latest.ckpt``; its KID / PRDC against float64 numpy on the same
    features and permutations; the s2d stem against the plain one. →
    kernel launches."""
    import numpy as np
    import torch

    from jckx_torch import evaluate
    from jckx_torch.data.pipeline import resize_bilinear
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.metrics import extra, inception_v3
    from jckx_torch.metrics.metrics import IMAGENET_MEAN, IMAGENET_STD

    seen = {}
    real_kid, real_mm = extra.kid, extra.manifold_metrics

    def kid_spy(real, fake, **kw):
        seen["kid"] = (np.asarray(real), np.asarray(fake), kw)
        return real_kid(real, fake, **kw)

    def mm_spy(real, fake, **kw):
        seen["prdc"] = (np.asarray(real), np.asarray(fake), kw)
        return real_mm(real, fake, **kw)

    latest = os.path.join(tr.save_path, "latest.ckpt")
    extra.kid, extra.manifold_metrics = kid_spy, mm_spy
    zero_launches()
    try:
        res = evaluate.main(["--ckpt", latest, "--dataset", "synthetic", "--kid", "1", "--prdc", "1",
                             "--eval_fast_stem", "1"] + _run_dir_args(tmp, "CGAN")[:4])
    finally:
        extra.kid, extra.manifold_metrics = real_kid, real_mm
    launches = fba.LAUNCHES
    MainLogger.reset()
    keys = ("kid", "kid_std", "precision", "recall", "density", "coverage")
    check(launches == 8 and all(math.isfinite(res[k]) for k in keys + ("fid", "intra_fid")),
          f"evaluate --kid --prdc --eval_fast_stem: {launches} launches, {res}")
    check_moments("evaluate --kid --prdc --eval_fast_stem", launches)
    real, fake, kw = seen["kid"]
    m = min(kw["subset_size"], len(real), len(fake))
    perms = extra.kid_permutations(len(real), len(fake), kw["subsets"], kw["seed"])
    ref_kid = kid_f64(real, fake, perms, m)
    kid_gap = abs(res["kid"] - ref_kid[0]) / max(abs(ref_kid[0]), 1e-12)
    check(kid_gap <= 1e-3 and abs(res["kid_std"] - ref_kid[1]) <= 1e-3 * abs(ref_kid[0]) + 1e-7,
          f"KID {res['kid']} ± {res['kid_std']} vs float64 {ref_kid}")
    ref_prdc = prdc_f64(real, fake)
    # f32 distances may put a point a rounding error across a k-NN radius:
    # up to 3 such points per share
    gaps = {k: abs(res[k] - v) for k, v in ref_prdc.items()}
    check(all(gaps[k] <= 3 / min(len(real), len(fake)) for k in gaps),
          f"PRDC {res} vs float64 {ref_prdc}")
    # the eval's shares all read 0 under the seeded random backbone, which
    # a constant would pass: so again on a pair whose manifolds overlap
    half = len(real) // 2
    a, b = real[:half], np.concatenate([real[half:half + 1024], fake[:1000]])
    overlap = extra.manifold_metrics(a, b, device=dev)
    ref_overlap = prdc_f64(a, b)
    overlap_gaps = {k: abs(overlap[k] - v) for k, v in ref_overlap.items()}
    check(all(0 < ref_overlap[k] < 1 for k in ("precision", "recall", "coverage"))
          and ref_overlap["density"] > 0
          and all(overlap_gaps[k] <= 3 / min(len(a), len(b)) for k in overlap_gaps),
          f"PRDC on overlapping manifolds {overlap} vs float64 {ref_overlap}")

    # the s2d stem against the plain one, f32 (TF32 off), on 64 of the eval's fakes
    net = inception_v3.init(0, num_classes=tr.num_classes).to(dev).eval()
    x = 0.5 * tr.sample_eval()[:64].float() + 0.5
    x = (resize_bilinear(x, 299) - torch.tensor(IMAGENET_MEAN, device=dev)) / torch.tensor(
        IMAGENET_STD, device=dev)
    with torch.inference_mode():
        plain, s2d = (net(x, torch.float32, fast_stem=f) for f in (False, True))
        plain16, s2d16 = (net(x, torch.bfloat16, fast_stem=f) for f in (False, True))
    rel = ((s2d - plain).abs().max() / plain.abs().max()).item()
    rel16 = ((s2d16 - plain16).abs().max() / plain16.abs().max()).item()
    check(rel <= 1e-3, f"s2d stem features vs the plain stem's, f32: {rel} of the largest")
    print(f"evaluate --kid 1 --prdc 1 --eval_fast_stem 1 on the CGAN run's latest.ckpt: "
          f"{launches} kernel launches; kid {res['kid']:.6g} ± {res['kid_std']:.3g} "
          f"(float64: gap {kid_gap:.2g} relative), precision {res['precision']:.4f} recall "
          f"{res['recall']:.4f} density {res['density']:.4f} coverage {res['coverage']:.4f} "
          f"(float64 gaps {gaps}) over {len(real)} real / {len(fake)} fake; on overlapping "
          f"manifolds ({len(a)} real against {len(b)} of real and fake) "
          + ", ".join(f"{k} {overlap[k]:.4f}" for k in sorted(overlap))
          + f" (float64 gaps {overlap_gaps}); s2d stem features vs plain: {rel:.2g} (f32), "
          f"{rel16:.2g} (bf16) of the largest")
    return launches


def phase_panel(tmp: str) -> int:
    """``python -m jckx_torch panel`` over seeds 0 and 1, DCGAN at full
    width with KID / PRDC and the s2d stem. → the children's kernel
    launches, as each child trainer logged them."""
    root = os.path.join(tmp, "panel_save")
    argv = ["panel", "--seeds", "0,1", "-m", "DCGAN", "--dataset", "synthetic", "-e", "1",
            "--extra_metrics", "1", "--eval_fast_stem", "1", "-mlr", str(TRAIN_LR),
            "--log_every", "8", "--eval_every", "16", "--save_root", root,
            "--data_dir", os.path.join(tmp, "data"), "--panel_name", "smoke"]
    out = _cli(argv, timeout=900)
    check(out.returncode == 0, f"panel exited {out.returncode}: {out.stderr[-3000:]}")
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    per = verdict["per_seed"]
    check(verdict["ok"] and verdict["seeds"] == [0, 1] and set(per) == {"0", "1"}
          and all(r["evals"] == 3 and "best_kid" in r and "best_precision" in r
                  for r in per.values())
          and {"best_kid", "best_precision", "best_fid"} <= set(verdict["aggregate"]),
          f"panel verdict {verdict}")
    counted = re.findall(r"fused BN kernel launches in this process: (\d+), moments "
                         r"kernels: (\d+)", out.stderr)
    launches = [int(n) for n, _ in counted]
    check(launches == [4 * 3, 4 * 3], f"the panel's trainers logged {launches} kernel launches, "
                                      f"want 12 each (4 per eval)")
    for i, (n, m) in enumerate(counted):
        check_moments(f"the panel's trainer {i}", int(n), int(m))
    agg = verdict["aggregate"]
    print(f"panel of seeds 0, 1 (DCGAN, 64², width 64, bs{TRAIN_BATCH}, 32 steps, 3 evals each, "
          f"KID / PRDC, s2d stem) through python -m jckx_torch panel: kernel launches "
          f"{launches}; " + ", ".join(f"{k} {agg[k]['min']:.4g}..{agg[k]['max']:.4g}"
                                      for k in sorted(agg)))
    return sum(launches)




def _bn_relu_grads(fn, x, scale, bias, dout):
    """``fn``'s (out, mean, var) and the gradients of sum(out · dout)."""
    x = x.detach().requires_grad_(True)
    scale, bias = scale.detach().requires_grad_(True), bias.detach().requires_grad_(True)
    out, mean, var = fn(x, scale, bias)
    (out.float() * dout).sum().backward()
    return out.detach(), mean, var, x.grad, scale.grad, bias.grad


@contextlib.contextmanager
def route_sums(x):
    """While inside, the plain routes' sums (``bn_moments_plain``) have the
    value of the moments kernels' sums of x and the plain sums' gradient:
    the plain route under the kernel route's own statistics."""
    from jckx_torch.kernels import fused_bn_act as fba

    kernel, plain = fba.bn_moments(fba._rows(x)), fba.bn_moments_plain

    def sums(xf):
        p = plain(xf)
        return kernel + (p - p.detach())

    fba.bn_moments_plain = sums
    try:
        yield
    finally:
        fba.bn_moments_plain = plain


def phase_bn_relu_train(dev) -> None:
    """``ops/norm.bn_relu_train`` (the moments and normalize kernels'
    forward, the hand-written backward) against ``bn_relu_train_plain``
    (autograd through plain ops), both on the card, bf16, at
    ``FT_BN_SHAPES`` (bs128, 299²): one normalize launch, two of the
    moments kernels and three of the backward's; the statistics against
    f64 statistics of the same x, no further off than the plain f32
    route's plus one f32 ulp of their scale (mean |x|, E[x²]); ``out``
    bit-identical to the normalize rounded once under the route's own a,
    sh; against the plain route under the route's statistics
    (``route_sums``; its ReLU mask, rounded once, is the backward kernels')
    dx within one bf16 ulp plus 1e-3 of its largest magnitude (both round
    an f32 dx to bf16; their f32 sums differ in order), dgamma / dbeta
    within 1e-3 of their largest magnitude (sums of up to 2.8 M products
    in another order)."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.ops.norm import bn_relu_train, bn_relu_train_plain

    def stat_errors(mean, var, x):
        xd = x.double()
        m1, m2, mabs = xd.mean((0, 2, 3)), (xd * xd).mean((0, 2, 3)), xd.abs().mean((0, 2, 3))
        return (((mean.double() - m1).abs() / mabs).max().item(),
                ((var.double() - (m2 - m1 * m1)).abs() / m2).max().item())

    g = torch.Generator(device=dev).manual_seed(3)
    for c, side in FT_BN_SHAPES:
        what = f"bn_relu_train at {FT_BATCH}x{c}x{side}x{side}"
        x = (torch.randn(FT_BATCH, c, side, side, generator=g, device=dev) * 2 + 0.5).to(
            torch.bfloat16, memory_format=torch.channels_last)
        scale = torch.rand(c, generator=g, device=dev) + 0.5
        bias = torch.randn(c, generator=g, device=dev)
        dout = torch.randn(FT_BATCH, c, side, side, generator=g, device=dev).contiguous(
            memory_format=torch.channels_last)
        before, bwd = launch_counts(), fba.BWD_LAUNCHES
        got = _bn_relu_grads(bn_relu_train, x, scale, bias, dout)
        torch.cuda.synchronize()
        check(launch_counts() == (before[0] + 1, before[1] + 2),
              f"{what} did not launch the normalize kernel once and the moments kernels twice")
        check_bwd(what, 1, fba.BWD_LAUNCHES - bwd)
        sums = fba.bn_moments_plain(x)
        n = x.numel() // c
        plain_mean = sums[0] / n
        err = stat_errors(got[1], got[2], x)
        err_plain = stat_errors(plain_mean, sums[1] / n - plain_mean * plain_mean, x)
        check(all(e <= e_plain + 2.0 ** -23 for e, e_plain in zip(err, err_plain)),
              f"{what}: statistics' error against f64 {err}, the plain route's {err_plain}")
        a = torch.rsqrt(got[2] + 1e-3) * scale
        sh = (bias - got[1] * a)[:, None, None]
        once = (x.double() * a[:, None, None].double() + sh.double()).float()
        check(torch.equal(got[0], torch.relu(once).to(torch.bfloat16)),
              f"{what}: out differs from the normalize rounded once under the route's a, sh")
        check(got[0].is_contiguous(memory_format=torch.channels_last), "out not channels_last")
        del once
        with route_sums(x):
            plain = _bn_relu_grads(lambda *a: bn_relu_train_plain(*a, one_rounding=True), x,
                                   scale, bias, dout)
        check(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
              and torch.equal(got[2], plain[2]),
              f"{what}: the plain route under the route's statistics differs in out or them")
        gaps = {name: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                for name, a, b in zip(("dx", "dgamma", "dbeta"), got[3:], plain[3:])}
        dx, ref = got[3].float(), plain[3].float()
        m = torch.maximum(dx.abs(), ref.abs())
        ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7), torch.zeros_like(m))
        check(bool(((dx - ref).abs() <= ulp + 1e-3 * ref.abs().max()).all()), f"dx {gaps}")
        check(gaps["dgamma"] <= 1e-3 and gaps["dbeta"] <= 1e-3, f"dgamma / dbeta {gaps}")
        print(f"{what} bf16 on the card: launches 1 + 2 + 3; statistics against f64 "
              f"{err[0]:.3g} / {err[1]:.3g} (the plain route {err_plain[0]:.3g} / "
              f"{err_plain[1]:.3g}); out bit-identical to the normalize rounded once; relative "
              f"gaps to the plain route under the same statistics "
              + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
        del x, dout, got, plain, dx, ref, m, ulp


def _flat_deltas(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before if not k.endswith(("bn_mean", "bn_var"))}


def phase_finetune_vs_cpu(dev) -> None:
    """One fine-tune step at 299², batch 8, f32, TF32 off (set in ``main``),
    on the card against the same step on the CPU: the same seeded weights,
    indices, crop draws and dropout mask. The loss within 1e-3; each
    leaf's SGD delta within 10 % of the CPU's in norm, the fc's within 1e-2
    of its largest element everywhere (through 94 batch-statistic BN layers
    the convolutions' f32 sums, taken in another order, move the deep
    layers' gradients by a few per cent: tests/test_torch_finetune_step.py);
    the running statistics within 1e-3 of their layer's largest; 94 kernel
    launches on the card, none on the CPU. The gaps are printed beside the
    CPU's own against weights perturbed by 1e-7 relative."""
    import numpy as np
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.metrics import inception_v3 as tiv
    from jckx_torch.metrics.inception_train import draw_step, make_optimizer, make_train_step

    n = 8
    g = torch.Generator().manual_seed(11)
    data = torch.randint(0, 256, (64, 32, 32, 3), generator=g, dtype=torch.uint8)
    labels = torch.randint(0, 100, (64,), generator=g)
    idx = torch.randperm(64, generator=g)[:n]
    draws = draw_step(torch.Generator().manual_seed(12), n)
    out = []
    # the CPU twice: as given, and with every weight scaled by 1 + 1e-7·N(0, 1),
    # the noise floor of the comparison
    for device, perturb in ((torch.device("cpu"), 0.0), (torch.device("cpu"), 1e-7), (dev, 0.0)):
        net = tiv.init(0, num_classes=100)
        if perturb:
            with torch.no_grad():
                for p in net.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=torch.Generator().manual_seed(5)))
        net = net.to(device)
        step = make_train_step(net, make_optimizer(net, 0.1), torch.float32, FT_SIZE)
        before_flat = tiv.to_jckx_flat(net)
        before, bwd = launch_counts(), fba.BWD_LAUNCHES
        loss, acc = step(data.to(device), labels.to(device), idx.to(device),
                         type(draws)(type(draws.crops)(*(t.to(device) for t in draws.crops)),
                                     draws.keep.to(device)))
        loss = float(loss)
        want = FT_CONVS if device.type == "cuda" else 0
        check(launch_counts() == (before[0] + want, before[1] + 2 * want),
              f"the fine-tune step on {device} launched {launch_counts()} from {before}, want "
              f"{want} normalize launches and {2 * want} of the moments kernels")
        check_bwd(f"the fine-tune step on {device}", want, fba.BWD_LAUNCHES - bwd)
        out.append((loss, float(acc), before_flat, tiv.to_jckx_flat(net)))
    (lc, ac, b0, pc), (_, _, b1, pp), (lg, ag, _, pg) = out
    check(math.isfinite(lg) and abs(lg - lc) <= 1e-3, f"fine-tune loss card {lg} vs CPU {lc}")
    dc, dg, dp = _flat_deltas(b0, pc), _flat_deltas(b0, pg), _flat_deltas(b1, pp)
    gaps = {k: float(np.linalg.norm(dg[k] - dc[k]) / np.linalg.norm(dc[k])) for k in dc}
    floor = [float(np.linalg.norm(dp[k] - dc[k]) / np.linalg.norm(dc[k])) for k in dc]
    worst = max(gaps, key=gaps.get)
    check(gaps[worst] <= 0.1, f"fine-tune delta of {worst}: card vs CPU gap {gaps[worst]:.3g}")
    for k in ("fc/w", "fc/b"):
        err = float(np.abs(dg[k] - dc[k]).max() / np.abs(dc[k]).max())
        check(err <= 1e-2, f"{k} delta card vs CPU: {err:.3g} of its largest")
    stat_gap = max(float(np.abs(pg[k] - pc[k]).max() / np.abs(pc[k]).max())
                   for k in pc if k.endswith(("bn_mean", "bn_var")))
    check(stat_gap <= 1e-3, f"running statistics card vs CPU: {stat_gap:.3g}")
    print(f"fine-tune step card vs CPU (299², batch {n}, f32, TF32 off): loss {lg:.6f} vs {lc:.6f} "
          f"(|diff| {abs(lg - lc):.3g} <= 1e-3), acc {ag} vs {ac}; SGD deltas within "
          f"{gaps[worst]:.3g} of the CPU's in norm at worst ({worst}; <= 0.1), median "
          f"{statistics.median(gaps.values()):.3g} (the CPU with its weights perturbed by 1e-7 "
          f"relative: at worst {max(floor):.3g}, median {statistics.median(floor):.3g}); running "
          f"statistics {stat_gap:.3g} (<= 1e-3); {FT_CONVS} kernel launches and {3 * FT_CONVS} "
          f"of the backward's on the card, none on the CPU")


def phase_finetune(ctr, tmp: str) -> int:
    """``python -m jckx_torch finetune`` in this process through its
    ``train()`` at the notebook's geometry (299², bs128, bf16), 2 epochs of
    8 steps on 2560 synthetic rows, eval on 512: exactly 94 launches per
    step and none from the evals; finite losses; the ``.npz`` files and
    ``summary.json``; ``--resume 1`` starts at epoch 2 and trains nothing;
    ``loss_bset.npz`` as ``--metric_backbone`` of ``evaluate`` on the CGAN
    run's ``latest.ckpt``. → kernel launches (the run's and the
    evaluate's)."""
    from jckx_torch import evaluate
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.metrics.inception_train import get_args, train

    save = os.path.join(tmp, "finetune")
    argv = ["--dataset", "synthetic", "--synthetic_size", "2560", "-b", str(FT_BATCH), "-e", "2",
            "--max_steps_per_epoch", "8", "--image_size", str(FT_SIZE), "--eval_samples", "512",
            "--save_dir", save, "--data_dir", os.path.join(tmp, "data")]
    zero_launches()
    run = train(get_args(argv))
    launches, bwd = fba.LAUNCHES, fba.BWD_LAUNCHES
    MainLogger.reset()
    steps = sum(e["steps"] for e in run.epochs)
    check(steps == 16 and [e["epoch"] for e in run.epochs] == [0, 1],
          f"fine-tune ran epochs {[e['epoch'] for e in run.epochs]}, {steps} steps")
    check(launches == FT_CONVS * steps,
          f"{launches} kernel launches over {steps} fine-tune steps and 2 evals; want "
          f"{FT_CONVS} per step and none from the evals")
    check_moments("the fine-tune's steps and evals", launches)
    check_bwd("the fine-tune's steps and evals", launches, bwd)
    check(all(math.isfinite(e["train_loss"]) and math.isfinite(e["loss"]) for e in run.epochs),
          f"fine-tune losses not finite: {run.epochs}")
    wrote = {f for e in run.epochs for f in e["written"]}
    check({"loss_bset.npz", "last_bset.npz", "train_state.npz"} <= wrote, f"wrote {wrote}")
    for f in wrote | {"summary.json"}:
        check(os.path.isfile(os.path.join(save, f)), f"{f} missing")
    check(("acc_bset.npz" in wrote) == (run.best_acc > 0), "acc_bset.npz against best top-1")
    with open(os.path.join(save, "summary.json")) as f:
        side = json.load(f)
    check(side["epochs_run"] == 2 and side["batch_size"] == FT_BATCH, f"summary {side}")
    print(f"fine-tune through python -m jckx_torch finetune's train(): 2 epochs x 8 steps at "
          f"bs{FT_BATCH}, {FT_SIZE}², bf16: {launches} kernel launches = {FT_CONVS} x {steps} "
          f"steps, 0 from the evals, and {bwd} of the backward's; "
          + "; ".join(f"epoch {e['epoch']}: train loss {e['train_loss']:.4f}, valid top1 "
                      f"{e['top1']:.4f} loss {e['loss']:.4f}, {len(e['written'])} files written"
                      for e in run.epochs))

    before = launch_counts()
    again = train(get_args(argv + ["--resume", "1"]))
    MainLogger.reset()
    check(again.start_epoch == 2 and again.epochs == [] and launch_counts() == before,
          f"--resume 1 started at epoch {again.start_epoch} and ran {again.epochs}")
    print("fine-tune --resume 1 on the same save dir: restored epoch 2, nothing left to train")

    zero_launches()
    res = evaluate.main(["--ckpt", os.path.join(ctr.save_path, "latest.ckpt"), "--dataset",
                         "synthetic", "--metric_backbone", os.path.join(save, "loss_bset.npz")]
                        + _run_dir_args(tmp, "CGAN")[:4])
    ev_launches = fba.LAUNCHES
    MainLogger.reset()
    check(math.isfinite(res["fid"]) and math.isfinite(res["is"]) and ev_launches == 8,
          f"evaluate over the fine-tuned backbone: {res}, {ev_launches} launches")
    check_moments("evaluate --metric_backbone", ev_launches)
    print(f"evaluate --metric_backbone finetune/loss_bset.npz on the CGAN run's latest.ckpt: "
          f"{ev_launches} kernel launches; fid {res['fid']:.4f} is {res['is']:.4f} intra_fid "
          f"{res['intra_fid']:.4f}")
    return launches + ev_launches


SUPERSTEP_STEPS = 8   # _mesh_graph_gan: steps held bit for bit


def _step_trainer(tmp: str, model: str, run: str, mesh):
    """A trainer at the reference geometry (bs128, bf16, lr 2e-4, EMA
    0.999) over the 4,096 synthetic rows, over ``mesh``, built as
    ``train.main.run`` builds it but with no evals: the phase drives its
    launches."""
    import torch

    from jckx_torch.configs import get_arg_parse
    from jckx_torch.data.pipeline import CGANDataPreprocessor, DCGANDataPreprocessor
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.models.dcgan import Discriminator, Generator
    from jckx_torch.train.gan_trainer import CGANTrainer, DCGANTrainer
    from jckx_torch.train.state import geometry

    cfg = get_arg_parse(["-m", model, "--dataset", "synthetic", "-b", str(TRAIN_BATCH), "-e", "1",
                         "-mlr", str(TRAIN_LR), "--eval_every", "0", "--ema_decay", "0.999"]
                        + _run_dir_args(tmp, model, run))
    cfg.save_path = os.path.join(cfg.save_root, model.lower(), run)
    geo, gen = geometry(cfg), torch.Generator().manual_seed(cfg.seed)
    MainLogger.reset()
    if model == "CGAN":
        data = CGANDataPreprocessor(cfg)
        cfg.num_classes = data.num_classes
        tr = CGANTrainer(cfg, CGenerator(geo, cfg.num_classes, gen=gen),
                         CDiscriminator(geo, cfg.num_classes, gen=gen), data, mesh=mesh)
    else:
        tr = DCGANTrainer(cfg, Generator(geo, gen=gen), Discriminator(geo, gen=gen),
                          DCGANDataPreprocessor(cfg), mesh=mesh)
    MainLogger.reset()
    return tr


def _trainer_tensors(tr) -> dict:
    """G, D, the EMA and both Adams' moments and counts, by name."""
    s = tr.state
    out = {f"{m}.{k}": v for m, net in (("G", s.G), ("D", s.D), ("EMA", s.ema_g))
           for k, v in net.state_dict().items()}
    for name, opt in (("opt_g", s.opt_g), ("opt_d", s.opt_d)):
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
    return out


@contextlib.contextmanager
def _no_host_sync():
    """``torch.cuda.set_sync_debug_mode("error")``: an operation that
    synchronises the host with the card raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def _deterministic_cudnn():
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before














def phase_inference_graph(tmp: str, dev, tr, ctr) -> int:
    """jckx's jitted inference programs as CUDA graphs
    (``utils/graphs.GraphedProgram``) at the reference geometry beside
    their eager routes (the program set to None), cuDNN deterministic:
    the two trainers' eval renders (``tr``: DCGAN, ``ctr``: CGAN);
    ``evaluate`` on the CGAN run's ``latest.ckpt``: its renders, features
    and FID / IS / intra-FID; the features of 10,000 fakes (the metrics
    engine's device path) and of the real set (its slab path, a second key
    of the program): bit for bit. (The served programs' replays are held
    by tests/test_torch_gpu.py.) → the kernel launches of the phase."""
    import numpy as np
    import torch

    from jckx_torch import evaluate as tevaluate
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.metrics import metrics as tmetrics

    start = launch_counts()
    with _deterministic_cudnn():
        for model, t in (("DCGAN", tr), ("CGAN", ctr)):
            t.eval_program.invalidate()  # captured again under deterministic cuDNN
            t.sample_eval()
            with _no_host_sync():
                got = t.sample_eval()
            with eager_route(t, "eval_program"):
                want = t.sample_eval()
            prog = t.eval_program
            check(torch.equal(got, want), f"{model} trainer: replayed eval renders differ from eager")
            print(f"{model} trainer: the eval renders of {t.eval_z.shape[0]} rows, replayed "
                  f"({prog.captures} capture, {prog.replays} replays), equal the eager route bit "
                  f"for bit")

        argv = ["--ckpt", os.path.join(ctr.save_path, "latest.ckpt"), "--dataset", "synthetic"
                ] + _run_dir_args(tmp, "CGAN")[:4]
        seen = {"fake": [], "feats": [], "program": [], "engine": []}
        real = (tevaluate.sample_eval_images, tmetrics.Metrics.extract_features,
                tevaluate.eval_program, tevaluate.graph_for, tmetrics.graph_for)

        def spy_sample(*a, **k):
            seen["fake"].append(real[0](*a, **k))
            return seen["fake"][-1]

        def spy_extract(self, images):
            seen["engine"].append(self.program)
            seen["feats"].append(real[1](self, images))
            return seen["feats"][-1]

        def spy_program(*a):
            seen["program"].append(real[2](*a))
            return seen["program"][-1]

        tevaluate.sample_eval_images, tmetrics.Metrics.extract_features = spy_sample, spy_extract
        tevaluate.eval_program = spy_program
        try:
            scored = [tevaluate.evaluate(tevaluate.get_args(argv))]
            MainLogger.reset()
            tevaluate.graph_for = tmetrics.graph_for = lambda *a, **k: (None, "the eager route")
            scored.append(tevaluate.evaluate(tevaluate.get_args(argv)))
            MainLogger.reset()
        finally:
            (tevaluate.sample_eval_images, tmetrics.Metrics.extract_features,
             tevaluate.eval_program, tevaluate.graph_for, tmetrics.graph_for) = real
        check(seen["program"][0] is not None and seen["engine"][0] is not None
              and seen["program"][1] is None and seen["engine"][1] is None,
              "evaluate: the graph route has no programs or the eager route has some")
        check(torch.equal(*seen["fake"]) and np.array_equal(*seen["feats"]),
              "evaluate: replayed renders or features differ from the eager route")
        check(scored[0] == scored[1], f"evaluate: {scored[0]} through the graphs, {scored[1]} eager")
        print(f"evaluate on the CGAN run's latest.ckpt: renders (2 forwards of 500), features and "
              f"{ {k: scored[0][k] for k in ('fid', 'is', 'intra_fid')} } equal the eager route's "
              f"exactly")

        m = tr.metric  # the DCGAN run's engine: batch 256, bf16
        fakes = (torch.rand((FEATURE_ROWS, tr.geo.image_size, tr.geo.image_size, 3), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(6)) * 2 - 1
                 ).to(torch.bfloat16)
        m.program.invalidate()
        got = m.extract_features(fakes)
        with eager_route(m):
            want = m.extract_features(fakes)
        check(np.array_equal(got, want), f"the features of {FEATURE_ROWS} rows through the graph "
                                         f"differ from the eager route")
        real_u8 = tr.data_pre.metric_source[0]  # the host path: slabs of the 32² real set
        got = m._extract_u8(real_u8)  # a second key, in the program's one pool
        with eager_route(m):
            want = m._extract_u8(real_u8)
        check(np.array_equal(got, want) and len(m.program.keys) == 2,
              "the real set's features through the graph differ from the eager route")
        print(f"the InceptionV3 features of {FEATURE_ROWS} fakes at batch {m.batch_size} and of "
              f"the {len(real_u8)} real rows (the slab path, a second graph in the program's "
              f"pool; {m.program.replays} replays) equal the eager route's bit for bit")
    launches = fba.LAUNCHES - start[0]
    check_moments("phase_inference_graph", launches, launch_counts()[1] - start[1])
    del fakes
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_remat(dev, card: str) -> None:
    """One full-width DCGAN step (64², z 100, width 64, batch 128, bf16)
    under each ``--remat`` mode from the same weights and draws: the
    parameters after the step against ``none``'s (Adam deltas within 5 % of
    lr where ``none``'s gradient clears 1 % of its leaf's maximum, on all
    but 0.1 % of those elements; the max |diff| printed), and the peak
    device memory of a second step, beside the card's name and power
    limit."""
    import torch

    from jckx_torch.configs import Config
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.train.state import create_dcgan_state
    from jckx_torch.train.steps import make_dcgan_train_step, make_draws

    geo = GANGeometry()
    g = torch.Generator(device=dev).manual_seed(11)
    real = torch.rand((TRAIN_BATCH, 64, 64, 3), generator=g, device=dev) * 2 - 1
    draws = make_draws(0, 0, TRAIN_BATCH, geo, dev)
    out = {}
    for mode in ("none", "g", "d", "both"):
        cfg = Config()
        cfg.max_learning_rate, cfg.remat = TRAIN_LR, mode
        gen = torch.Generator().manual_seed(0)
        state = create_dcgan_state(cfg, Generator(geo, gen=gen).to(dev),
                                   Discriminator(geo, gen=gen).to(dev))
        nets = {"G.": state.G, "D.": state.D}
        p0 = {p + k: v.detach().cpu().clone() for p, net in nets.items()
              for k, v in net.named_parameters()}
        step = make_dcgan_train_step(cfg, geo)
        m = step(state, real, draws)
        delta = {p + k: v.detach().cpu() - p0[p + k] for p, net in nets.items()
                 for k, v in net.named_parameters()}
        grads = {p + k: v.grad.detach().cpu() for p, net in nets.items()
                 for k, v in net.named_parameters()}
        check(all(math.isfinite(float(v)) for v in m.values()), f"remat={mode}: telemetry {m}")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, real, draws)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[mode] = (delta, grads, peak, held)
        del state, nets, step
        torch.cuda.empty_cache()
    d_none, g_none = out["none"][0], out["none"][1]
    for mode, (delta, _, peak, held) in out.items():
        worst = max(float((delta[k] - d_none[k]).abs().max()) for k in d_none)
        covered = flipped = 0
        for k, gk in g_none.items():
            mask = gk.abs() > 1e-2 * gk.abs().max() + 1e-12
            covered += int(mask.sum())
            bad = int(((delta[k] - d_none[k]).abs() > 0.05 * TRAIN_LR)[mask].sum())
            flipped += bad
            check(bad <= 1e-3 * int(mask.sum()),
                  f"remat={mode}: {k}: {bad} of {int(mask.sum())} masked deltas differ from none's")
        print(f"--remat {mode}: parameters after one step max |diff| from none {worst:.3g} "
              f"({flipped} of {covered} masked deltas beyond 5 % of lr); peak device memory of a "
              f"step {peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} GiB above the state)"
              f"   [{card}]")


def phase_sanitize(dev) -> None:
    """``--sanitize``'s context (``train.main.run_modes``) on a full-width
    DCGAN step (batch 128, bf16, cuDNN deterministic for the phase): a clean
    step under anomaly detection equals the plain step bit for bit; a real
    batch holding a NaN raises anomaly mode's error naming the backward
    function; the global flag is off again after."""
    import warnings

    import torch

    from jckx_torch.configs import Config
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.train import main as tmain
    from jckx_torch.train.state import create_dcgan_state
    from jckx_torch.train.steps import make_dcgan_train_step, make_draws

    geo = GANGeometry()
    g = torch.Generator(device=dev).manual_seed(12)
    real = torch.rand((TRAIN_BATCH, 64, 64, 3), generator=g, device=dev) * 2 - 1
    draws = make_draws(0, 0, TRAIN_BATCH, geo, dev)
    cfg = Config()
    cfg.max_learning_rate = TRAIN_LR

    def one_step(sanitize: bool, batch):
        cfg.sanitize = sanitize
        gen = torch.Generator().manual_seed(0)
        state = create_dcgan_state(cfg, Generator(geo, gen=gen).to(dev),
                                   Discriminator(geo, gen=gen).to(dev))
        with tmain.run_modes(cfg, dev), warnings.catch_warnings():
            warnings.simplefilter("ignore")  # anomaly mode's own notice
            m = make_dcgan_train_step(cfg, geo)(state, batch, draws)
        torch.cuda.synchronize()
        return m, {**state.G.state_dict(), **{"D." + k: v for k, v in state.D.state_dict().items()}}

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        (m0, p0), (m1, p1) = one_step(False, real), one_step(True, real)
        check(all(torch.equal(m0[k], m1[k]) for k in m0) and all(torch.equal(p0[k], p1[k]) for k in p0),
              "--sanitize changed a clean step")
        bad = real.clone()
        bad[0, 5, 7, 1] = float("nan")
        msg = ""
        try:
            one_step(True, bad)
        except RuntimeError as e:
            msg = str(e)
    finally:
        torch.backends.cudnn.deterministic = prev
    found = re.search(r"Function '(\w+)' returned nan values", msg)
    check(found is not None, f"a NaN batch under --sanitize did not raise anomaly mode's error: {msg!r}")
    check(not torch.is_anomaly_enabled(), "anomaly detection left on after the run")
    print(f"--sanitize: a clean full-width step equals the plain one bit for bit; a NaN in the "
          f"real batch raised naming {found.group(1)}")


def phase_profile_dir(tmp: str) -> int:
    """A short ``--profile_dir`` run through the entry point (DCGAN, full
    width, 512 synthetic rows, batch 128: 4 steps and one eval): it writes
    one Chrome trace that names the kernel's operator and its device
    kernel (the eval sample) and a cuDNN convolution. → its launches."""
    import glob

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.train import main as tmain

    trace_dir = os.path.join(tmp, "trace")
    argv = ["-m", "DCGAN", "--dataset", "synthetic", "--synthetic_size", "512", "-b",
            str(TRAIN_BATCH), "-e", "1", "-mlr", str(TRAIN_LR), "--log_every", "4",
            "--eval_every", "4", "--profile_dir", trace_dir, "--save_root",
            os.path.join(tmp, "save"), "--data_dir", os.path.join(tmp, "data_profile"),
            "-pm", "smoke_profile"]
    zero_launches()
    tr = tmain.main(argv)
    launches = fba.LAUNCHES
    MainLogger.reset()
    check(tr.state.step == 4 and tr.evals == [4] and launches == tr.geo.n_up,
          f"--profile_dir run: step {tr.state.step}, evals {tr.evals}, {launches} launches")
    check_moments("the --profile_dir run", launches)
    traces = glob.glob(os.path.join(trace_dir, "jckx_torch_*.pt.trace.json"))
    check(len(traces) == 1, f"--profile_dir wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    has = {"jckx_torch::normalize_act": "jckx_torch::normalize_act" in names,
           "the kernel (bn_act_*)": any("bn_act_vec" in n or "bn_act_scalar" in n for n in names),
           "aten::cudnn_convolution": "aten::cudnn_convolution" in names}
    check(all(has.values()), f"the trace lacks {[k for k, v in has.items() if not v]}")
    # steps 2-4 are replays of the step's graph, and the eval's real features
    # after their first batch replays of the metrics engine's: their kernels,
    # correlated with the host's graph launches, are in the trace
    replays = {e["args"]["correlation"] for e in events if "cudaGraphLaunch" in e.get("name", "")
               and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in replays]
    want = 3 + tr.metric.program.replays
    check(len(replays) == want and len(kernels) >= 3 * 100,
          f"--profile_dir: {len(replays)} graph launches, {len(kernels)} kernels of theirs in the "
          f"trace; want {want} replays (3 steps') and the steps' kernels")
    print(f"--profile_dir: a run of 4 steps + 1 eval wrote {os.path.basename(traces[0])} "
          f"({os.path.getsize(traces[0]) / 2**20:.1f} MiB, {len(events)} events) naming "
          f"{', '.join(has)}, and {len(kernels)} device kernels of its {len(replays)} graph "
          f"launches (3 replayed steps, {want - 3} feature batches); {launches} kernel launches")
    return launches


def phase_jckx_ckpt(tmp: str) -> int:
    """jckx ``.ckpt`` files read without JAX: the committed fixture
    (tests/data/jckx_ckpt, written by jckx's trainer on the CPU; its renders
    through the kernel are held by tests/test_torch_gpu.py). Each file
    through ``evaluate`` end to end on the card (finite IS / FID at step
    4); ``convert`` to ``.pt`` and ``inspect`` exit 0; and ``train
    --resume`` of the DCGAN run dir takes one more eval and writes the
    port's ``latest.ckpt`` at step 8. → the kernel launches."""
    import shutil
    import zipfile

    from jckx_torch import convert as tconvert
    from jckx_torch import evaluate
    from jckx_torch import inspect as tinspect
    from jckx_torch.checkpoint.checkpoint import load_checkpoint, load_generator
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.train import main as tmain

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jckx_ckpt")
    data = os.path.join(tmp, "data_jckx")
    total = 0
    for family in ("dcgan", "cgan"):
        cgan = family == "cgan"
        path = os.path.join(root, family, "run", "latest.ckpt")
        lg = load_generator(path)
        zero_launches()
        res = evaluate.main(["--ckpt", path, "--dataset", "cifar10" if cgan else "synthetic",
                             "--synthetic_size", "512", "--data_dir", data, "--save_root",
                             os.path.join(tmp, "save"), "--compute_dtype", "float32"])
        MainLogger.reset()
        total += fba.LAUNCHES
        check(res["step"] == 4 and math.isfinite(res["fid"]) and math.isfinite(res["is"])
              and fba.LAUNCHES == lg.geo.n_up, f"evaluate {family} fixture: {res}, "
              f"{fba.LAUNCHES} launches")
        check_moments(f"evaluate {family} fixture", fba.LAUNCHES)
        pt = os.path.join(tmp, f"jckx_{family}.pt")
        check(tconvert.main(["--src", path, "--dst", pt]) == 0
              and load_checkpoint(pt)["model_g"].keys() == lg.G.state_dict().keys(),
              f"convert {path} -> {pt}")
        check(tinspect.main(["--ckpt", path]) == 0, f"inspect {path}")
        info = tinspect.inspect_path(path)
        check(info["kind"] == "jckx checkpoint (flax msgpack)" and info["step"] == 4,
              f"inspect {path}: {info}")
        print(f"jckx {family} .ckpt: evaluate step {res['step']} IS {res['is']:.4f} FID "
              f"{res['fid']:.4f} ({fba.LAUNCHES} launches); convert -> .pt and inspect exit 0")

    save = os.path.join(tmp, "save_jckx")
    shutil.copytree(os.path.join(root, "dcgan"), os.path.join(save, "dcgan"))
    zero_launches()
    tr = tmain.main(["--resume", "-pm", "run", "-e", "2", "--save_root", save, "--data_dir", data])
    MainLogger.reset()
    latest = os.path.join(save, "dcgan", "run", "latest.ckpt")
    check(tr.device.type == "cuda" and tr.state.step == 8 and tr.evals == [8]
          and fba.LAUNCHES == tr.geo.n_up and zipfile.is_zipfile(latest)
          and load_checkpoint(latest)["step"] == 8,
          f"--resume of jckx's run dir: step {tr.state.step}, evals {tr.evals}, "
          f"{fba.LAUNCHES} launches")
    check_moments("train --resume of jckx's DCGAN run dir", fba.LAUNCHES)
    print(f"train --resume of jckx's DCGAN run dir (step 4, {tr.cfg.compute_dtype}): one more eval "
          f"at step 8 ({fba.LAUNCHES} launches), the port's latest.ckpt written at step 8")
    return total + fba.LAUNCHES


def _per_batch_features(m, images, to01):
    """The metrics engine's host path before slabs: one pageable copy per
    batch, the last batch padded with its last row."""
    import numpy as np
    import torch

    n, bs, outs = images.shape[0], min(m.batch_size, images.shape[0]), []
    with torch.inference_mode():
        for i in range(0, n, bs):
            chunk = torch.from_numpy(np.array(images[i:i + bs])).to(m.device)
            if chunk.shape[0] < bs:
                chunk = torch.cat([chunk, chunk[-1:].expand(bs - chunk.shape[0], *chunk.shape[1:])])
            outs.append(m._features01(to01(chunk)))
        return torch.cat(outs)[:n].cpu().numpy()


def phase_data_planes(tmp: str, dev) -> int:
    """The data planes on the card (``data/native_io.py``, ``datasets.py``,
    ``pipeline.py``): the native library loads; a planted CIFAR-100 pickle
    of 50,000 rows is parsed and cached, then mapped; real features of
    10,000 mapped rows through the metrics engine's slab path (8 MB slabs:
    4 of them) equal the per-batch path's, with deterministic algorithms;
    CGAN streams the whole set under ``auto`` with a 100 MB budget, is cut
    by SIGTERM after its first launch of 8 steps and evaluated once; and
    the folder plane trains 4 steps where PIL imports, else refuses naming
    PIL. (A streamed trainer against a resident one, bit for bit, with its
    slabs copied on a stream that runs no kernel, is held by
    tests/test_torch_gpu.py.) → the kernel launches of its evals."""
    import pickle
    import signal
    import threading

    import numpy as np
    import torch

    from jckx_torch.configs import get_arg_parse
    from jckx_torch.data import datasets, native_io
    from jckx_torch.data.pipeline import CGANDataPreprocessor
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.artifacts import encode_png
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.metrics import inception_v3
    from jckx_torch.metrics.metrics import Metrics
    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.train import main as tmain
    from jckx_torch.train.gan_trainer import CGANTrainer
    from jckx_torch.train.state import geometry

    check(native_io.available(), f"the native I/O library did not load: "
                                 f"{native_io.fallback_reason()}")
    print(f"native I/O library {os.path.basename(native_io.library_path())} built with g++ and "
          f"loaded")

    data_dir = os.path.join(tmp, "planes_data")
    os.makedirs(os.path.join(data_dir, "cifar-100-python"))
    rng = np.random.default_rng(0)
    pix = rng.integers(0, 256, (DATA_ROWS, 3072), dtype=np.uint8)
    fine = rng.integers(0, 100, DATA_ROWS)
    with open(os.path.join(data_dir, "cifar-100-python", "train"), "wb") as f:
        pickle.dump({b"data": pix, b"fine_labels": fine.tolist()}, f, protocol=4)
    x1, y1, ncls, _, synthetic = datasets.load_dataset("cifar100", data_dir)
    cache = os.path.join(data_dir, "jckx_cache_cifar100_train.bin")
    check(os.path.getsize(cache) == 32 + DATA_ROWS * (3072 + 4) and not synthetic,
          f"cache {os.path.getsize(cache)} bytes")
    x, y, _, _, _ = datasets.load_dataset("cifar100", data_dir)
    check(np.array_equal(x, x1) and np.array_equal(y, y1) and not x.flags.writeable
          and np.array_equal(x, pix.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)),
          "the mapped cache differs from the parsed archive")
    print(f"CIFAR-100 pickle of {DATA_ROWS} rows: parsed and its cache written "
          f"({os.path.getsize(cache)} bytes), then the cache mapped; arrays equal")
    del x1, y1, pix

    # the metrics engine's slab path against its per-batch path, with
    # deterministic algorithms (without filling fresh memory: that would put
    # fill kernels on the copy stream)
    real = x[:FEATURE_ROWS]
    cd = torch.bfloat16
    deterministic = torch.backends.cudnn.deterministic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    saved_slab, Metrics._SLAB_BYTES = Metrics._SLAB_BYTES, FEATURE_SLAB_BYTES
    try:
        eng = Metrics((real, y[:FEATURE_ROWS]), backbone=inception_v3.init(0, num_classes=ncls),
                      batch_size=256, compute_dtype=cd, cache_dir=os.path.join(tmp, "planes_feat"),
                      num_classes=ncls, device=dev)
        to01 = lambda u8: u8.to(cd) / 255.0  # noqa: E731
        for path in ("per-batch", "slab"):
            f = (_per_batch_features(eng, real, to01) if path == "per-batch"
                 else eng._extract_u8(real))
            check(np.array_equal(f, eng.real_features), f"{path} features differ from the engine's")
    finally:
        Metrics._SLAB_BYTES = saved_slab
    bs = min(256, FEATURE_ROWS)
    n_slabs = math.ceil(math.ceil(FEATURE_ROWS / bs) / max(1, FEATURE_SLAB_BYTES // (3072 * bs)))
    check(n_slabs >= 2, f"{FEATURE_ROWS} rows fit one slab: the overlap is not exercised")
    print(f"real features of {FEATURE_ROWS} mapped rows, bs256, bf16, deterministic: the slab "
          f"path ({n_slabs} slabs of <= {FEATURE_SLAB_BYTES >> 20} MB, pinned, copied on a side "
          f"stream) and the per-batch path equal the engine's")

    zero_launches()
    try:
        # CGAN streams the whole mapped set under auto (153.6 MB > 100 MB)
        argv = ["-m", "CGAN", "--dataset", "cifar100", "--data_dir", data_dir, "-b",
                str(TRAIN_BATCH), "-e", "1", "-mlr", str(TRAIN_LR), "--log_every", "8",
                "--data_placement", "auto", "--hbm_data_budget", "100000000", "-w", "4",
                "--save_root", os.path.join(tmp, "save"), "-pm", "smoke_plane_auto"]
        cfg = get_arg_parse(argv)
        cfg.save_path = os.path.join(cfg.save_root, "cgan", cfg.model_path)
        data_pre = CGANDataPreprocessor(cfg)
        geo, gen = geometry(cfg), torch.Generator().manual_seed(cfg.seed)
        tr = CGANTrainer(cfg, CGenerator(geo, data_pre.num_classes, gen=gen),
                         CDiscriminator(geo, data_pre.num_classes, gen=gen), data_pre, metrics=eng)
        check(tr._streaming and tr.images_dev is None, "auto did not stream 153.6 MB over a "
                                                        "100 MB budget")
        real_launch, calls = tr._launch, [0]

        def cut(batches):
            calls[0] += 1
            if calls[0] == 1:
                os.kill(os.getpid(), signal.SIGTERM)  # preempt_save: latest.ckpt after this launch
            return real_launch(batches)

        tr._launch = cut
        tr.train()
        tr._evaluate(tr.state.step, [], [])
        left = [t.name for t in threading.enumerate() if t.name.startswith(("jckx-upload",
                                                                          "jckx-gather"))]
        with open(next(os.path.join(tr.save_path, f) for f in os.listdir(tr.save_path)
                       if f.endswith(".log"))) as f:
            plane_line = next(line.strip() for line in f if "data plane:" in line)
        MainLogger.reset()
        check(tr.preempted and tr.state.step == 8 and "host-streaming" in plane_line
              and "native gather" in plane_line, f"CGAN auto: step {tr.state.step}, {plane_line!r}")
        check(left == [], f"uploader / gather threads left after SIGTERM: {left}")
        print(f"CGAN K = {tr.num_classes} --data_placement auto --hbm_data_budget 100000000 on "
              f"the {DATA_ROWS}-row mapped set: logged {plane_line.split('] ', 1)[-1]!r}; SIGTERM "
              f"in its first launch saved latest.ckpt at step 8 and stopped the uploader; then one "
              f"eval")

        # the folder plane
        folder = os.path.join(tmp, "planes_folder")
        prng = np.random.default_rng(1)
        for i in range(64):
            d = os.path.join(folder, ("cat", "dog")[i % 2])
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"{i:02d}.png"), "wb") as f:
                f.write(encode_png(prng.integers(0, 256, (40 + i % 7, 36, 3), dtype=np.uint8)))
        argv = ["--dataset", "folder", "--data_path", folder, "-b", "16", "-e", "1", "-mlr",
                str(TRAIN_LR), "--log_every", "4", "--eval_every", "4", "--save_root",
                os.path.join(tmp, "save"), "--data_dir", data_dir, "-pm", "smoke_plane_folder"]
        folder_trained = False
        try:
            import PIL  # noqa: F401
        except ImportError:
            try:
                tmain.run(get_arg_parse(argv), metrics=eng)
            except ImportError as e:
                check("PIL" in str(e), f"--dataset folder without PIL raised {e!r}")
                print(f"--dataset folder: PIL is not importable here; the run refused with "
                      f"{type(e).__name__}: {e}")
            else:
                fail("--dataset folder trained without PIL")
            finally:
                MainLogger.reset()
        else:
            tr = tmain.run(get_arg_parse(argv), metrics=eng)
            MainLogger.reset()
            check(tr.state.step == 4 and tr.n_data == 64 and tr.num_classes == 2,
                  f"--dataset folder: step {tr.state.step}, {tr.n_data} rows")
            folder_trained = True
            print(f"--dataset folder: 64 PNGs in 2 classes trained 4 steps at batch 16, evals "
                  f"after {tr.evals}")
        launches = fba.LAUNCHES
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    # 4 per G forward: CGAN's eval of 2 forwards, the folder run's eval
    want = 4 * (2 + (1 if folder_trained else 0))
    check(launches == want, f"the data-plane phase launched the kernel {launches} times, want "
                            f"{want}: 4 per G forward of its evals")
    check_moments("the data-plane phase", launches)
    print(f"data-plane phase: {launches} kernel launches (its evals)")
    return launches


# ------------------------------------------------------------------ the mesh

MESH_STEPS = 4                          # phase_mesh: steps of each run (one launch, one eval;
                                        # cut from 8 for the script's time)
MESH_ROWS = TRAIN_BATCH * MESH_STEPS    # its synthetic rows: one epoch of MESH_STEPS steps
# phase_mesh_model's first-step rule: G's f32 gradient at full width is so
# ill-conditioned that nudging the weights by 1e-6 relative moves it 1.9 %
# in L2 and flips 20 masked Adam deltas (10 in each of two leaves), and a
# per-leaf 0.1 % bound allows no flip in a 495-element BN leaf; so the
# flips are counted over each net (0.1 % of its masked deltas), and every
# leaf's gradient must lie within 5 % in L2 of the plain run's (ROADMAP C:
# rounding error up to ~5 % of a leaf's largest gradient at full width)
MODEL_GRAD_GAP = 0.05
FT_MESH_BATCH = 8                       # fine-tune rows per rank


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_child(kind: str, spec: dict, rank: int = 0, world: int = 1, port: int = 0):
    """``python3 chip_smoke.py --child <kind> <spec>`` as rank ``rank`` of a
    world of ``world`` with torch's ``env://`` variables (``port`` 0: no
    group variables at all, a lone process)."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    if port:
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", kind,
                             json.dumps(spec)], cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _start_group(kind: str, spec: dict, world: int) -> list:
    port = _free_port()
    return [_start_child(kind, spec, r, world, port) for r in range(world)]


def _join(procs: list, what: str, timeout: float = 400) -> list:
    """Wait for the children; fail naming ``what`` on a non-zero exit. → stdouts."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail(f"{what}: a child did not finish within {timeout} s")
        check(p.returncode == 0, f"{what}: a child exited {p.returncode}:\n{err[-4000:]}")
        outs.append(out)
    return outs


def _child_init(backend: str):
    """A child's card, f32 without TF32, deterministic algorithms, and its
    process group: ``gloo`` over ``env://`` made here (the port keeps a
    group its caller made), ``nccl`` by the port's ``init_multihost``,
    ``port`` left to the entry point (``--multihost``), ``none``."""
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if backend == "gloo":
        dist.init_process_group("gloo", init_method="env://")
    elif backend == "nccl":
        from jckx_torch.utils.device import init_multihost

        ok, err = init_multihost(dev)
        check(ok, f"NCCL: {err}")
    return dev


def _warm_step(dev, conditional: bool) -> None:
    """One throwaway full-width f32 step: a process's first tiny f32 run
    can end a few ulp from later identical ones (PERF.md §7), so the runs
    compared bit for bit are never a process's first."""
    import torch

    from jckx_torch.configs import Config
    from jckx_torch.data.pipeline import one_hot
    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.train.state import create_dcgan_state
    from jckx_torch.train.steps import make_cgan_train_step, make_dcgan_train_step

    cfg, geo = Config(), GANGeometry()
    cfg.compute_dtype, cfg.max_learning_rate = "float32", TRAIN_LR
    gen = torch.Generator().manual_seed(99)
    real = torch.rand(16, 64, 64, 3, device=dev) * 2 - 1
    if conditional:
        G, D = CGenerator(geo, CGAN_CLASSES, gen=gen), CDiscriminator(geo, CGAN_CLASSES, gen=gen)
        step = make_cgan_train_step(cfg, geo)
        extra = (one_hot(torch.arange(16, device=dev) % CGAN_CLASSES, CGAN_CLASSES),)
    else:
        G, D = Generator(geo, gen=gen), Discriminator(geo, gen=gen)
        step = make_dcgan_train_step(cfg, geo)
        extra = ()
    step(create_dcgan_state(cfg, G.to(dev), D.to(dev)), real, *extra)
    torch.cuda.synchronize()


def _snapshot(state) -> dict:
    """G's and D's parameters and gradients, on the host, whole: a tensor-
    parallel state's slices are all-gathered (every rank must call it)."""
    from jckx_torch.parallel import tp

    rec = {}
    for name, net in (("G", state.G), ("D", state.D)):
        dims = tp.tp_dims(net)

        def whole(t, k):
            t = t.detach()
            if dims.get(k) is not None:
                t = state.mesh.all_gather(t, dims[k], "model")
            return t.cpu().clone()

        rec[name] = {k: whole(v, k) for k, v in net.state_dict().items()}
        rec[name + "_grad"] = {k: whole(p.grad, k) for k, p in net.named_parameters()}
    return rec


def child_train(spec: dict) -> None:
    """``jckx_torch.train.main.run`` on ``spec["argv"]`` in this child. Rank
    0 saves the parameters and gradients after the first step (with that
    step's telemetry) and after the last, every rank its kernel launches,
    to ``<out>.rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from jckx_torch.configs import get_arg_parse
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.train import gan_trainer
    from jckx_torch.train import main as tmain

    dev = _child_init(spec["backend"])
    _warm_step(dev, "CGAN" in spec["argv"])
    first, telemetry = {}, []
    train_step, launch = gan_trainer._BaseGANTrainer._train_step, gan_trainer._BaseGANTrainer._launch

    def step_and_keep_the_first(self, u8, labels):
        # a run's first step is eager on every path (the superstep's warm step)
        m = train_step(self, u8, labels)
        if not first:
            first.update(_snapshot(self.state), telemetry={k: float(v) for k, v in m.items()})
        return m

    def launch_and_keep_telemetry(self, batches):
        rows = launch(self, batches)
        telemetry.extend(dict(zip(METRIC_NAMES_ALL[:6], r)) for r in rows.tolist())
        return rows

    gan_trainer._BaseGANTrainer._train_step = step_and_keep_the_first
    gan_trainer._BaseGANTrainer._launch = launch_and_keep_telemetry
    zero_launches()
    tr = tmain.run(get_arg_parse(spec["argv"]))
    rank = dist.get_rank() if dist.is_initialized() else 0
    rec = {"launches": fba.LAUNCHES, "moments": launch_counts()[1], "step": tr.state.step,
           "evals": tr.evals,
           "superstep": None if tr.superstep is None else (tr.superstep.captures,
                                                           tr.superstep.replays)}
    last = _snapshot(tr.state)
    if spec.get("renders"):
        rec["renders_equal_once"] = _renders_equal_once(tr)
    if rank == 0:
        rec.update(last, first=first, telemetry=telemetry)
    torch.save(rec, f"{spec['out']}.rank{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()






def _ft_step_run(dev, mesh=None) -> list:
    """Two fine-tune steps at 299², f32, from ``init(0)`` on a global batch
    of ``2 · FT_MESH_BATCH`` (each rank its rows over ``mesh``). → the flat
    weights before and after each step, on the host."""
    import torch

    from jckx_torch.metrics import inception_v3 as tiv
    from jckx_torch.metrics.inception_train import draw_step, make_optimizer, make_train_step

    n = 2 * FT_MESH_BATCH
    g = torch.Generator().manual_seed(11)
    data = torch.randint(0, 256, (64, 32, 32, 3), generator=g, dtype=torch.uint8).to(dev)
    labels = torch.randint(0, 100, (64,), generator=g).to(dev)
    net = tiv.init(0, num_classes=100).to(dev)
    step = make_train_step(net, make_optimizer(net, 0.1), torch.float32, FT_SIZE, mesh)
    draws_gen = torch.Generator().manual_seed(12)
    snaps = [tiv.to_jckx_flat(net)]
    for _ in range(2):
        idx = torch.randperm(64, generator=g)[:n].to(dev)
        d = draw_step(draws_gen, n)
        step(data, labels, idx, type(d)(type(d.crops)(*(t.to(dev) for t in d.crops)),
                                         d.keep.to(dev)))
        snaps.append(tiv.to_jckx_flat(net))
    return snaps


def child_finetune(spec: dict) -> None:
    """``_ft_step_run`` over the gloo pair; rank 0 saves the snapshots,
    every rank its kernel launches."""
    import torch
    import torch.distributed as dist

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.parallel import make_mesh

    dev = _child_init("gloo")
    zero_launches()
    snaps = _ft_step_run(dev, make_mesh((2,), device=dev))
    rec = {"launches": fba.LAUNCHES, "moments": launch_counts()[1]}
    if dist.get_rank() == 0:
        rec["snaps"] = snaps
    torch.save(rec, f"{spec['out']}.rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


def _renders_equal_once(tr) -> tuple:
    """The trainer's eval render again through the kernel (a TP generator
    gathered first, as its evals do) and through ``bn_act_one_rounding``:
    → (bit-identical, the render's shape)."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.parallel import tp
    from jckx_torch.train.gan_trainer import sample_eval_images

    G = tr.state.ema_g if tr.state.ema_g is not None else tr.state.G
    if getattr(G, "tp_dims", None) is not None:
        G = tp.gathered(G, tr.mesh)

    def render():
        return sample_eval_images(G, tr.eval_z, tr.eval_onehot, tr.cd, tr.mesh)

    got = render()
    once = with_bn_act(fba.bn_act_one_rounding, render)
    return bool(torch.equal(got, once)), tuple(got.shape)




def child_planes(spec: dict) -> None:
    """``phase_data_planes`` in a process of its own: its deterministic
    algorithms want ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts
    (``_start_child`` sets it), and its global settings stay out of the
    script's process. Writes its launches to ``spec["out"]``."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    launches = phase_data_planes(spec["tmp"], dev)
    with open(spec["out"], "w") as f:
        json.dump({"launches": launches, "moments": launch_counts()[1]}, f)


def phase_data_planes_alone(tmp: str) -> int:
    """``phase_data_planes`` in a child process (``child_planes``), its
    lines printed here. → its kernel launches."""
    out = os.path.join(tmp, "planes_out.json")
    (stdout,) = _join([_start_child("planes", {"tmp": tmp, "out": out})],
                      "phase_data_planes", timeout=900)
    print(stdout, end="")
    with open(out) as f:
        rec = json.load(f)
    check_moments("phase_data_planes", rec["launches"], rec["moments"])
    return rec["launches"]


MESH_GRAPH_WORLDS = ("world of one", "forced-live world of one")


def _forced_live_mesh(dev):
    """A ``ProcessMesh`` over this process's NCCL world of one whose every
    axis is live, so the step issues its real collectives (the port skips
    an axis of size 1). They are sums over one rank, so the results stay
    bit-exact. NCCL runs an in-place sum over one rank as no device work at
    all, so the sums go as ``PREMUL_SUM`` by 1.0, which NCCL runs over one
    rank as one ``oneRankReduce`` kernel per call (x · 1.0 = x exactly):
    each captured collective is then a node of the graph, which every
    replay runs."""
    import torch.distributed as dist

    from jckx_torch.parallel.mesh import ProcessMesh

    premul_one = dist._make_nccl_premul_sum(1.0)

    class ForcedLiveMesh(ProcessMesh):
        def _live(self, axis: str) -> bool:
            return self.distributed

        def _sum(self, t, axis: str) -> None:
            dist.all_reduce(t, op=premul_one, group=self._groups[axis])

    return ForcedLiveMesh((1,), ("data",), dev)


def _stats_since(stats, snap) -> dict:
    """{kind: (calls, bytes, replayed calls)} counted since ``snap``."""
    return {k: (stats.calls[k] - snap["calls"][k], stats.bytes[k] - snap["bytes"][k],
                stats.replayed[k] - snap["replayed"][k]) for k in stats.KINDS}


def _check_replayed(one: dict, got: dict, k: int, what: str) -> None:
    """``got`` (``_stats_since`` over k replays) holds k times ``one`` (an
    eager step's), every call marked as replayed."""
    want = {kind: (k * c, k * b, k * c) for kind, (c, b, _) in one.items()}
    check(got == want, f"{what}: mesh.stats over {k} replays {got}, want {want}")




def _mesh_graph_gan(tmp: str, mesh, world: str, dev) -> None:
    """DCGAN and CGAN over ``mesh``, bs128 bf16, 8 steps through the
    superstep (1 eager and captured, 7 replays under
    ``set_sync_debug_mode("error")``) against 8 eager steps of a twin, bit
    for bit (cuDNN deterministic), ``mesh.stats`` over the replays 7 times
    an eager step's; then DCGAN's eval renders (graph and eager) and their
    InceptionV3 features over the mesh, bit for bit."""
    import numpy as np
    import torch

    from jckx_torch.metrics import inception_v3 as tiv
    from jckx_torch.metrics.metrics import Metrics
    from jckx_torch.train.superstep import CudaGraph

    live = world != MESH_GRAPH_WORLDS[0]
    tag = "live" if live else "plain"  # the two worlds run at once: their own dirs
    n = SUPERSTEP_STEPS
    perm = torch.randperm(4096, generator=torch.Generator().manual_seed(5))
    rows = [{"idx": r} for r in perm[:n * TRAIN_BATCH].view(n, TRAIN_BATCH).to(dev).unbind()]
    keep = None
    for model in ("DCGAN", "CGAN"):
        eager = _step_trainer(tmp, model, f"mesh_graph_{tag}_eager", mesh)
        graphed = _step_trainer(tmp, model, f"mesh_graph_{tag}_graph", mesh)
        check(graphed.superstep is not None and graphed.superstep.graph_cls is CudaGraph
              and graphed.eval_program is not None,
              f"{model} over the NCCL {world}: the trainer on the card has no CUDA graph")
        eager.superstep = None
        with _deterministic_cudnn():
            snap = mesh.stats.snapshot()
            want = eager._launch(rows)
            torch.cuda.synchronize()
            per_step = {k: (c // n, b // n, r) for k, (c, b, r) in
                        _stats_since(mesh.stats, snap).items()}
            got = [graphed._launch(rows[:1])]
            snap = mesh.stats.snapshot()
            with _no_host_sync():
                got.append(graphed._launch(rows[1:]))
            torch.cuda.synchronize()
            replayed = _stats_since(mesh.stats, snap)
        ss = graphed.superstep
        check((ss.captures, ss.replays, ss.launches) == (1, n - 1, 0),
              f"{model} over the NCCL {world}: {ss.captures} captures, {ss.replays} replays")
        check(torch.equal(torch.cat(got), want),
              f"{model} over the NCCL {world}: replayed telemetry differs from eager")
        a, b = _trainer_tensors(graphed), _trainer_tensors(eager)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        check(a.keys() == b.keys() and not differ,
              f"{model} over the NCCL {world}: replayed steps differ from eager in {differ[:5]}")
        calls = per_step["all_reduce"][0]
        check((calls > 0) == live, f"{model} over the NCCL {world}: {calls} all-reduces a step")
        _check_replayed(per_step, replayed, n - 1, f"{model} over the NCCL {world}")
        print(f"{model} over the NCCL {world} ({TRAIN_BATCH} rows, bf16): {n} steps through "
              f"the superstep (1 eager, then captured, {n - 1} replayed with no host "
              f"synchronisation) equal {n} eager steps bit for bit (telemetry and "
              f"{sum(v.numel() for v in a.values()):,} values of G, D, the EMA and Adam); "
              f"{calls} all-reduces a step ({per_step['all_reduce'][1]:,} bytes), counted "
              f"{n - 1} times over as replayed")
        if model == "DCGAN":
            keep = graphed
        del eager, graphed, a, b
        gc.collect()

    tr = keep
    g = torch.Generator().manual_seed(23)
    real = torch.randint(0, 256, (EVAL_BATCH, 32, 32, 3), generator=g, dtype=torch.uint8).numpy()
    engine = Metrics((real, np.arange(EVAL_BATCH) % 100), None,
                     backbone=tiv.init(0, num_classes=100), batch_size=EVAL_BATCH,
                     compute_dtype=torch.bfloat16,
                     cache_dir=os.path.join(tmp, f"mesh_graph_cache_{tag}"), num_classes=100,
                     device=dev, mesh=mesh)
    check(engine.program is not None, f"the metrics engine over the NCCL {world} has no graph")
    with _deterministic_cudnn():
        with programs_eager():
            want = tr.sample_eval()
            want_f = engine.extract_features(want)
        got = [tr.sample_eval()]  # the eval program's capture
        with _no_host_sync():
            got.append(tr.sample_eval())
        got_f = engine.extract_features(got[1])
        torch.cuda.synchronize()
    check(all(torch.equal(x, want) for x in got) and np.array_equal(got_f, want_f),
          f"the graphed eval renders or features over the NCCL {world} differ from eager")
    print(f"DCGAN's eval over the NCCL {world}: {EVAL_BATCH} renders through the graph (the "
          f"rows, sync-BN through the kernel and the gather inside it) and their InceptionV3 "
          f"features through the engine's graph equal the eager ones bit for bit")
    del tr, engine
    gc.collect()
    torch.cuda.empty_cache()


def _mesh_graph_finetune(mesh, world: str, dev) -> int:
    """The fine-tune at 299², bs128, bf16 over ``mesh``: 1 eager step and a
    launch of K = 8 replays against 9 eager steps bit for bit (cuDNN
    deterministic), 94 launches a step either way, ``mesh.stats`` over the
    replays 8 times an eager step's. → the kernel launches."""
    import numpy as np
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.metrics import inception_v3 as tiv
    from jckx_torch.metrics.inception_train import (draw_step, make_optimizer, make_superstep,
                                                    make_train_step, step_inputs)
    from jckx_torch.train.superstep import CudaGraph

    g = torch.Generator().manual_seed(21)
    data = torch.randint(0, 256, (2560, 32, 32, 3), generator=g, dtype=torch.uint8).to(dev)
    labels = torch.randint(0, 100, (2560,), generator=g).to(dev)
    order = torch.randperm(2560, generator=g)[:9 * FT_BATCH].view(9, FT_BATCH).to(dev)

    def fresh():
        net = tiv.init(0, num_classes=100).to(dev)
        return net, make_train_step(net, make_optimizer(net, 0.1), torch.bfloat16, FT_SIZE, mesh)

    def feed(gen, first):
        return lambda j: step_inputs(order[(first + j) % 9], draw_step(gen, FT_BATCH, dev))

    with _deterministic_cudnn():
        net_e, step_e = fresh()
        gen = torch.Generator(device=dev).manual_seed(7)
        snap, before, bwd = mesh.stats.snapshot(), fba.LAUNCHES, fba.BWD_LAUNCHES
        want = torch.stack([torch.stack(step_e(data, labels, order[i],
                                               draw_step(gen, FT_BATCH, dev))) for i in range(9)])
        torch.cuda.synchronize()
        eager_launches, eager_bwd = fba.LAUNCHES - before, fba.BWD_LAUNCHES - bwd
        per_step = {k: (c // 9, b // 9, r) for k, (c, b, r) in
                    _stats_since(mesh.stats, snap).items()}
        want_w = tiv.to_jckx_flat(net_e)
        del net_e, step_e
        gc.collect()
        net, step = fresh()
        ss = make_superstep(step, data, labels, CudaGraph, mesh)
        gen = torch.Generator(device=dev).manual_seed(7)
        before, bwd = fba.LAUNCHES, fba.BWD_LAUNCHES
        got = [ss.replay(1, feed(gen, 0))]
        snap = mesh.stats.snapshot()
        with _no_host_sync():
            got.append(ss.replay(8, feed(gen, 1)))
        torch.cuda.synchronize()
        replayed = _stats_since(mesh.stats, snap)
        graph_launches, graph_bwd = fba.LAUNCHES - before, fba.BWD_LAUNCHES - bwd
    check_bwd(f"fine-tune over the NCCL {world}, eager", eager_launches, eager_bwd)
    check_bwd(f"fine-tune over the NCCL {world}, replayed", graph_launches, graph_bwd)
    check(eager_launches == graph_launches == 9 * FT_CONVS and ss.launches == FT_CONVS,
          f"fine-tune over the NCCL {world}: launches eager {eager_launches}, graph "
          f"{graph_launches}; want {9 * FT_CONVS}")
    check(torch.equal(torch.cat(got), want),
          f"fine-tune over the NCCL {world}: replayed loss / accuracy differ from eager")
    got_w = tiv.to_jckx_flat(net)
    differ = [k for k in want_w if not np.array_equal(want_w[k], got_w[k])]
    check(not differ, f"fine-tune over the NCCL {world}: the K = 8 launch differs in {differ[:5]}")
    _check_replayed(per_step, replayed, 8, f"fine-tune over the NCCL {world}")
    calls = per_step["all_reduce"][0]
    print(f"fine-tune over the NCCL {world} ({FT_SIZE}², bs{FT_BATCH}, bf16): 1 eager step + "
          f"a launch of K = 8 replays equal 9 eager steps bit for bit; {FT_CONVS} kernel "
          f"launches a step either way; {calls} all-reduces a step, counted 8 times over as "
          f"replayed")
    del ss, step, net
    gc.collect()
    torch.cuda.empty_cache()
    return eager_launches + graph_launches


def child_mesh_graph(spec: dict) -> None:
    """``phase_mesh_graph``'s work in a NCCL world of one (``_start_child``'s
    ``env://`` group, brought up by the port's ``init_multihost``), on
    ``spec["world"]``: the plain world's mesh or the forced-live one
    (``_forced_live_mesh``), through ``_mesh_graph_gan`` and
    ``_mesh_graph_finetune``. Writes its kernel launches and the moments
    kernels' to ``spec["out"]``."""
    import torch
    import torch.distributed as dist

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.parallel import make_mesh

    dev = _child_init("nccl")
    torch.use_deterministic_algorithms(False)  # cuDNN deterministic for the checks only
    tmp, world = spec["tmp"], spec["world"]
    zero_launches()
    mesh = _forced_live_mesh(dev) if world != MESH_GRAPH_WORLDS[0] else make_mesh((1,), device=dev)
    _mesh_graph_gan(tmp, mesh, world, dev)
    _mesh_graph_finetune(mesh, world, dev)
    with open(spec["out"], "w") as f:
        json.dump({"launches": fba.LAUNCHES, "moments": launch_counts()[1]}, f)
    dist.destroy_process_group()


def start_mesh_graph(tmp: str, world: str) -> tuple:
    """``child_mesh_graph`` on ``world`` started: → ([the process], its
    output file)."""
    out = os.path.join(tmp, f"mesh_graph_{world.replace(' ', '_')}.json")
    return [_start_child("mesh_graph", {"tmp": tmp, "world": world, "out": out}, 0, 1,
                         _free_port())], out


def phase_mesh_graph(outs: list) -> int:
    """The compiled programs over a NCCL process mesh (``utils/graphs.py``,
    ``graph_for`` over a ``ProcessMesh``) at full width, each world in a
    child process holding a NCCL world of one (``child_mesh_graph``, run
    beside ``phase_mesh``'s runs, which print its lines): the plain world
    (no collective runs on an axis of one) and the forced-live world, whose
    every step issues its collectives. ``outs``: the two worlds' output
    files. → the kernel launches of both."""
    launches = 0
    for world, path in zip(MESH_GRAPH_WORLDS, outs):
        with open(path) as f:
            one = json.load(f)
        # the GAN's eval renders and the fine-tune's BN forwards take the moments kernels
        check_moments(f"phase_mesh_graph, {world}", one["launches"], one["moments"])
        launches += one["launches"]
    return launches


def _mesh_argv(tmp: str, model: str, run: str, extra=()) -> list:
    return ["-m", model, "--dataset", "synthetic", "--synthetic_size", str(MESH_ROWS),
            "-b", str(TRAIN_BATCH), "-e", "1", "-mlr", str(TRAIN_LR), "--compute_dtype", "float32",
            "--log_every", str(MESH_STEPS), "--eval_every", str(MESH_STEPS),
            "--eval_batch_size", "64",
            "--save_root", os.path.join(tmp, "mesh_save", run),
            "--data_dir", os.path.join(tmp, "mesh_data", run), "-pm", run, *extra]


def _masked_gap(start: dict, got: dict, want: dict, grads: dict) -> tuple:
    """phase_train_vs_cpu's rule for one step: deltas from ``start`` where
    ``grads`` clears 1 % of its leaf's maximum, within 5 % of lr on all but
    0.1 %. → (worst leaf's flipped share, covered share), failing on a
    breach."""
    total = covered = 0
    worst = 0.0
    for k, g in grads.items():
        mask = g.abs() > 1e-2 * g.abs().max() + 1e-12
        bad = (((got[k] - start[k]) - (want[k] - start[k])).abs() > 0.05 * TRAIN_LR)[mask]
        n_bad, n = int(bad.sum()), int(mask.sum())
        check(n_bad <= 1e-3 * n, f"{k}: {n_bad} of {n} masked Adam deltas differ by > 5 % of lr")
        worst = max(worst, n_bad / max(n, 1))
        total += mask.numel()
        covered += n
    check(covered / total > 0.5, f"the gradient mask covers {covered}/{total} elements")
    return worst, covered / total


def _init_params(model: str):
    import torch

    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator

    gen, geo = torch.Generator().manual_seed(12345), GANGeometry()  # the trainer's seed
    nets = ((CGenerator(geo, CGAN_CLASSES, gen=gen), CDiscriminator(geo, CGAN_CLASSES, gen=gen))
            if model == "CGAN" else (Generator(geo, gen=gen), Discriminator(geo, gen=gen)))
    return [{k: v.detach().clone() for k, v in n.state_dict().items()} for n in nets]


def _metrics_of(tmp: str, model: str, run: str) -> dict:
    path = os.path.join(tmp, "mesh_save", run, model.lower(), run, "metrics.jsonl")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return {k: v for r in recs for k, v in r.items() if k in METRIC_NAMES_ALL}


METRIC_NAMES_ALL = ("loss_d", "gp", "d_x", "d_gz1", "loss_g", "d_gz2", "fid", "is", "intra_fid")


def phase_mesh_serve(path: str, svc, dev) -> int:
    """``GeneratorService`` over a local mesh ``[cuda:0, cuda:0]`` (the
    request batch split over two worker threads, BN statistics summed over
    both) against the unsharded service on the same requests: bs512 bf16,
    within 1 LSB, at least 99 % exact; 4 launches per device per batch.
    → the launches."""
    import numpy as np

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.parallel import make_mesh
    from jckx_torch.serve import GeneratorService

    mesh = make_mesh((2,), devices=[dev, dev])
    two = GeneratorService(path, mesh=mesh)  # the defaults: batch 512, bf16
    check(two.mesh.size == 2 and two.device == dev, "the mesh service's device")
    two.sample(BATCH, seed=0)  # warm
    n = 4 * BATCH
    zero_launches()
    got = two.sample(n, seed=5)
    launches = fba.LAUNCHES
    check(launches == 4 * 2 * 4, f"the mesh service launched {launches} kernels for 4 batches, "
                                 f"want 32 (4 per device per batch)")
    check_moments("the mesh service", launches)
    want = svc.sample(n, seed=5)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    exact = float((diff == 0).mean())
    check(diff.max() <= 1 and exact >= 0.99,
          f"sharded renders vs unsharded: max {diff.max()} LSB, {100 * exact:.4f} % exact")
    print(f"serving over a local mesh [cuda:0, cuda:0] (bs{BATCH} bf16, each device 256 rows, "
          f"global statistics): {launches} kernel launches for 4 batches (4 per device per "
          f"batch); against the unsharded service on the same requests max {diff.max()} LSB, "
          f"{100 * exact:.4f} % exactly equal")
    return launches


def phase_mesh(tmp: str, dev, also: dict = None) -> int:
    """The data axis of the mesh at full width (64², base width 64, global
    batch 128, ``MESH_STEPS`` steps and one eval of each run, f32, TF32
    off), in child processes (``--child``), most at once:

    - the plain single-rank run of DCGAN and of CGAN (K = 100), and DCGAN
      on a NCCL world of one (``--mesh_shape 1 --multihost`` from
      ``env://``): its parameters bit-identical to the plain run's;
    - two gloo ranks on this card (``--device cuda:0`` each, gloo copying
      each collective through the host), DCGAN and CGAN, against the plain
      run on their first step (telemetry within 3e-3, masked Adam deltas:
      ``_masked_gap``); the last step's
      telemetry gap is printed with every step's, not held: GAN training at
      full width parts the two runs about tenfold a step from the
      reassociated sums of the first, where the plain run repeats itself
      bit for bit. The kernel runs on each rank's rows at the eval, after
      the statistics' all-reduce;
    - two fine-tune steps at 299², 8 rows per rank, f32 on the gloo pair
      against the single rank in this process: the first step's deltas
      within 10 % in norm per leaf; the second's printed (the seeded random
      backbone's second step is chaotic: tests/test_torch_dp_metrics.py).

    ``also`` (name → started processes: ``phase_mesh_graph``'s worlds) runs
    beside the runs; its output is printed. → the kernel launches of the
    mesh runs."""
    import numpy as np
    import torch

    out = os.path.join(tmp, "mesh_out")
    os.makedirs(out, exist_ok=True)

    def spec(name, argv=(), backend="none"):
        return {"backend": backend, "argv": list(argv), "out": os.path.join(out, name)}

    procs = {
        "plain": [_start_child("train", spec("plain", _mesh_argv(tmp, "DCGAN", "plain",
                                                                ["--device", "cuda"])))],
        "plain_cgan": [_start_child("train", spec("plain_cgan", _mesh_argv(
            tmp, "CGAN", "plain_cgan", ["--device", "cuda"])))],
        "nccl": [_start_child("train", spec("nccl", _mesh_argv(
            tmp, "DCGAN", "nccl", ["--device", "cuda", "--mesh_shape", "1", "--multihost"]),
            backend="port"), 0, 1, _free_port())],
        "gloo": _start_group("train", spec("gloo", _mesh_argv(
            tmp, "DCGAN", "gloo", ["--device", "cuda:0", "--mesh_shape", "2"]), "gloo"), 2),
        "gloo_cgan": _start_group("train", spec("gloo_cgan", _mesh_argv(
            tmp, "CGAN", "gloo_cgan", ["--device", "cuda:0", "--mesh_shape", "2"]), "gloo"), 2),
        "finetune": _start_group("finetune", spec("finetune"), 2),
    }
    # the single-rank fine-tune reference, here meanwhile
    ft_one = _ft_step_run(dev)
    for name, ps in procs.items():
        _join(ps, f"phase_mesh {name}")
    for name, ps in (also or {}).items():
        print("".join(_join(ps, name, timeout=900)), end="")
    load = lambda name, r=0: torch.load(os.path.join(out, f"{name}.rank{r}.pt"),  # noqa: E731
                                        weights_only=False)
    runs = {name: [load(name, r) for r in range(len(ps))] for name, ps in procs.items()}

    # (1) NCCL world of one against the plain run: bit for bit
    plain, nccl = runs["plain"][0], runs["nccl"][0]
    for net in ("G", "D"):
        for k, v in plain[net].items():
            check(torch.equal(nccl[net][k], v), f"NCCL world of one: {net}.{k} differs from the "
                                                f"plain run after {MESH_STEPS} steps")
    check(nccl["step"] == plain["step"] == MESH_STEPS and nccl["launches"] == 4,
          f"NCCL world of one: step {nccl['step']}, {nccl['launches']} launches (want 4)")
    check_moments("NCCL world of one", nccl["launches"], nccl["moments"])
    graphed = (1, MESH_STEPS - 1)
    check(tuple(nccl["superstep"] or ()) == tuple(plain["superstep"] or ()) == graphed,
          f"NCCL world of one: superstep {nccl['superstep']}, plain run {plain['superstep']}; "
          f"want {graphed} (captures, replays)")
    n_params = sum(v.numel() for net in ("G", "D") for v in plain[net].values())
    print(f"NCCL world of one (--mesh_shape 1 --multihost, env://) against the plain run, both "
          f"through the superstep's CUDA graph (1 capture, {MESH_STEPS - 1} replays each): "
          f"{n_params:,} parameter values bit-identical after {MESH_STEPS} steps (DCGAN 64², "
          f"width 64, bs{TRAIN_BATCH}, f32, deterministic algorithms); 4 kernel launches at its "
          f"eval")

    # (2) the gloo pairs against the plain runs
    launches = nccl["launches"]
    for model, pair, ref in (("DCGAN", "gloo", "plain"), ("CGAN", "gloo_cgan", "plain_cgan")):
        r0, r1 = runs[pair]
        one = runs[ref][0]
        want = 4 if model == "DCGAN" else 8  # per rank: 1 forward of 32 rows; 2 chunks of 250
        check(r0["launches"] == r1["launches"] == want and r0["evals"] == [MESH_STEPS],
              f"{model} gloo pair: launches {r0['launches']} / {r1['launches']}, want {want} per "
              f"rank; evals {r0['evals']}")
        for r, rec in enumerate((r0, r1)):
            check_moments(f"{model} gloo pair, rank {r}", rec["launches"], rec["moments"])
        launches += r0["launches"] + r1["launches"]
        t1, t1_one = r0["first"]["telemetry"], one["first"]["telemetry"]
        gaps = {k: abs(t1[k] - t1_one[k]) for k in t1_one}
        for k, gap in gaps.items():
            check(gap <= 3e-3 + 3e-3 * abs(t1_one[k]), f"{model} gloo pair, step 1, {k}: {t1[k]} "
                                                        f"vs {t1_one[k]}")
        start = _init_params(model)
        flips = [_masked_gap(start[i], r0["first"][net], one["first"][net],
                             one["first"][net + "_grad"]) for i, net in enumerate(("G", "D"))]
        tele, tele_one = _metrics_of(tmp, model, pair), _metrics_of(tmp, model, ref)
        last = {k: abs(tele[k] - tele_one[k]) for k in METRIC_NAMES_ALL[:6]}
        per_step = [max(abs(a[k] - b[k]) for k in a)
                    for a, b in zip(r0["telemetry"], one["telemetry"])]
        check(all(math.isfinite(tele[k]) for k in METRIC_NAMES_ALL[:6] + ("fid",)),
              f"{model} gloo pair: non-finite metrics {tele}")
        print(f"{model} on two gloo ranks of this card (--device cuda:0 each, bs{TRAIN_BATCH} "
              f"global, 64 per rank, f32) against the plain run: step 1 telemetry max |diff| "
              f"{max(gaps.values()):.3g} (<= 3e-3), masked Adam deltas within 5 % of lr on all "
              f"but {100 * max(f for f, _ in flips):.4f} % (G covers {100 * flips[0][1]:.1f} %, "
              f"D {100 * flips[1][1]:.1f} %); after step {MESH_STEPS} telemetry max |diff| "
              f"{max(last.values()):.3g} (not held; by step: "
              f"{', '.join(f'{g:.2g}' for g in per_step)}), eval fid {tele['fid']:.6g} vs "
              f"{tele_one['fid']:.6g}; kernel launches {r0['launches']} + {r1['launches']} at "
              f"the eval (each rank's rows, after the statistics' all-reduce)")

    # (3) the fine-tune pair against the single rank
    ft = runs["finetune"]
    check(ft[0]["launches"] == ft[1]["launches"] == 2 * FT_CONVS,
          f"fine-tune pair launches {ft[0]['launches']} / {ft[1]['launches']}, want {2 * FT_CONVS}")
    for r, rec in enumerate(ft):
        check_moments(f"fine-tune pair, rank {r}", rec["launches"], rec["moments"])
    launches += ft[0]["launches"] + ft[1]["launches"]
    snaps = ft[0]["snaps"]
    for s in (1, 2):
        d_one, d_dp = _flat_deltas(ft_one[0], ft_one[s]), _flat_deltas(ft_one[0], snaps[s])
        gap = {k: abs(float(np.linalg.norm(d_dp[k])) - float(np.linalg.norm(d_one[k])))
               / float(np.linalg.norm(d_one[k])) for k in d_one if np.linalg.norm(d_one[k]) > 0}
        worst = max(gap, key=gap.get)
        check(all(math.isfinite(v) for v in gap.values()), f"fine-tune pair step {s}: non-finite")
        if s == 1:
            check(gap[worst] <= 0.1, f"fine-tune pair step 1: {worst}'s delta norm {gap[worst]:.3g} "
                                     f"from the single rank's")
        print(f"fine-tune on two gloo ranks (299², {FT_MESH_BATCH} rows per rank, f32, lr 0.1) "
              f"against one rank, after step {s}: delta norms at worst {gap[worst]:.3g} apart "
              f"({worst}), median {statistics.median(gap.values()):.3g}"
              + (" (<= 0.1)" if s == 1 else " (not held: chaotic)")
              + f"; {2 * FT_CONVS} launches per rank")

    print(f"phase_mesh: {launches} kernel launches on the mesh runs")
    return launches


def phase_mesh_model(tmp: str) -> int:
    """The mesh's model axis (``--mesh_shape 1,2 --mesh_axes data,model``)
    at full width (64², base width 64, global batch 128, ``MESH_STEPS``
    steps and one eval, f32, TF32 off), each run a gloo pair of child
    processes sharing this card (NCCL cannot put two ranks on one GPU),
    all at once:

    - DCGAN under ``--model_axis_mode tp`` (``--tp_min_dim 128``: G's
      512 / 256 / 128 stages and D's 128 / 256 / 512 sharded) and under
      ``spatial``, and CGAN (K = 100) under ``tp``, each against
      ``phase_mesh``'s plain run of the same command on the first step:
      telemetry within 3e-3, masked Adam deltas within 5 % of lr on all
      but 0.1 % of each net's, and every leaf's gradient within 5 % in L2
      (``MODEL_GRAD_GAP`` says why);
    - DCGAN under ``spatial --spatial_replicate_grads 0`` (Adam on each
      rank's half of the flat parameters) against ``1``: the first step's
      parameters within 1e-6 of each leaf's largest magnitude, the last
      step's gap printed;
    - the eval of each run: the kernel's launches on every rank (a TP
      generator all-gathered first, then 4 per DCGAN render, 8 per CGAN
      render), and the render bit-identical to ``bn_act_one_rounding``;
    - the TP run's ``latest.ckpt`` (full tensors) served by
      ``GeneratorService`` (4 launches for a batch of 64).

    → the kernel launches of the runs' evals and the serve."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.serve import GeneratorService

    out = os.path.join(tmp, "mesh_out")
    pair = ["--device", "cuda:0", "--mesh_shape", "1,2", "--mesh_axes", "data,model",
            "--multihost"]
    runs = {"tp": ("DCGAN", ["--model_axis_mode", "tp"]),
            "spatial": ("DCGAN", ["--model_axis_mode", "spatial"]),
            "spatial_rg0": ("DCGAN", ["--model_axis_mode", "spatial",
                                      "--spatial_replicate_grads", "0"]),
            "tp_cgan": ("CGAN", ["--model_axis_mode", "tp"])}
    procs = {name: _start_group("train", {
        "backend": "gloo", "renders": True, "out": os.path.join(out, name),
        "argv": _mesh_argv(tmp, model, name, pair + flags)}, 2)
        for name, (model, flags) in runs.items()}
    for name, ps in procs.items():
        _join(ps, f"phase_mesh_model {name}")
    load = lambda name, r=0: torch.load(os.path.join(out, f"{name}.rank{r}.pt"),  # noqa: E731
                                        weights_only=False)
    res = {name: [load(name, r) for r in range(2)] for name in runs}
    plain = {"DCGAN": load("plain"), "CGAN": load("plain_cgan")}
    launches = 0
    for name, (model, _) in runs.items():
        r0, r1 = res[name]
        one = plain[model]
        want = 4 if model == "DCGAN" else 8  # one render of 64, or 1000 rows in chunks of 500
        check(r0["launches"] == r1["launches"] == want and r0["evals"] == [MESH_STEPS],
              f"{name}: launches {r0['launches']} / {r1['launches']}, want {want} per rank; "
              f"evals {r0['evals']}")
        for r, rec in enumerate((r0, r1)):
            check_moments(f"{name}, rank {r}", rec["launches"], rec["moments"])
        check(r0["renders_equal_once"][0] and r1["renders_equal_once"][0],
              f"{name}: the eval render differs from the plain route with the kernel's rounding")
        launches += r0["launches"] + r1["launches"]
        t1, t1_one = r0["first"]["telemetry"], one["first"]["telemetry"]
        gaps = {k: abs(t1[k] - t1_one[k]) for k in t1_one}
        for k, gap in gaps.items():
            check(gap <= 3e-3 + 3e-3 * abs(t1_one[k]), f"{name}, step 1, {k}: {t1[k]} vs "
                                                        f"{t1_one[k]}")
        start = _init_params(model)
        for i, net in enumerate(("G", "D")):
            check({k: v.shape for k, v in r0["first"][net].items()}
                  == {k: v.shape for k, v in one["first"][net].items()},
                  f"{name}: the gathered {net} has other shapes than the plain run's")
        gaps_g = _pair_gaps(start, r0["first"], one["first"], grads=name != "spatial_rg0")
        for net, v in gaps_g.items():
            check(v["flipped"] <= 1e-3 * v["masked"] and v["covered"] > 0.5,
                  f"{name} {net}: {v['flipped']} of {v['masked']} masked Adam deltas differ by "
                  f"> 5 % of lr (covered {v['covered']:.3f})")
            check(v["grad_gap"] <= MODEL_GRAD_GAP, f"{name} {net}.{v['grad_gap_leaf']}: gradient "
                                                   f"{v['grad_gap']:.3g} from the plain run's in L2")
        tele = _metrics_of(tmp, model, name)
        tele_one = _metrics_of(tmp, model, "plain" if model == "DCGAN" else "plain_cgan")
        check(all(math.isfinite(tele[k]) for k in METRIC_NAMES_ALL[:6] + ("fid",)),
              f"{name}: non-finite metrics {tele}")
        last = max(abs(tele[k] - tele_one[k]) for k in METRIC_NAMES_ALL[:6])
        print(f"{model} {name} on a (1, 2) data x model mesh of two gloo ranks of this card "
              f"(bs{TRAIN_BATCH}, f32) against the plain run: step 1 telemetry max |diff| "
              f"{max(gaps.values()):.3g} (<= 3e-3; by field: {_fields_text(gaps)}); "
              + _gaps_text(gaps_g)
              + f"; after step {MESH_STEPS} telemetry max |diff| "
              f"{last:.3g} (not held), eval fid {tele['fid']:.6g} vs {tele_one['fid']:.6g}; "
              f"{r0['launches']} + {r1['launches']} kernel launches at the eval, render "
              f"{r0['renders_equal_once'][1]} bit-identical to bn_act_one_rounding")
    on, off = res["spatial"][0], res["spatial_rg0"][0]
    for when in ("first", "last"):
        a = on["first"] if when == "first" else on
        b = off["first"] if when == "first" else off
        gap = max(float((b[net][k] - v).abs().max()) / (float(v.abs().max()) + 1e-30)
                  for net in ("G", "D") for k, v in a[net].items() if v.is_floating_point())
        if when == "first":
            check(gap <= 1e-6, f"spatial_replicate_grads 0 vs 1 after step 1: {gap:.3g} of a "
                               f"leaf's largest magnitude")
        print(f"--spatial_replicate_grads 0 against 1 (DCGAN spatial, f32) after "
              f"{'step 1' if when == 'first' else f'step {MESH_STEPS}'}: parameters at most "
              f"{gap:.3g} of a leaf's largest magnitude apart"
              + (" (<= 1e-6)" if when == "first" else " (not held)"))

    # the TP run's checkpoint, served
    ckpt = os.path.join(tmp, "mesh_save", "tp", "dcgan", "tp", "latest.ckpt")
    svc = GeneratorService(ckpt, batch_size=64, compute_dtype=torch.bfloat16, device="cuda")
    before = launch_counts()
    images = svc.sample(64, seed=0)
    served = fba.LAUNCHES - before[0]
    check_moments("the TP checkpoint served", served, launch_counts()[1] - before[1])
    check(images.shape == (64, 64, 64, 3) and svc.step == MESH_STEPS and served == 4,
          f"the TP checkpoint served {images.shape} at step {svc.step} with {served} launches")
    launches += served
    print(f"the TP run's latest.ckpt (full tensors, step {svc.step}) served by GeneratorService: "
          f"64 images, {served} kernel launches")

    print(f"phase_mesh_model: {launches} kernel launches")
    return launches


def _fields_text(gaps: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())


# ---------------------------------------------------------------- the planner

# jckx.plan's XLA count for the same step: ``python -m jckx.plan --topology ""
# --devices 1 -m DCGAN -b 128 --compute_dtype float32`` at 64², width 64 (CPU)
JCKX_PLAN_F32_FLOPS = 3.916e11
PLAN_RUNS = {  # name: ``plan`` flags beyond the reference geometry in bf16
    "dp8": ["--devices", "8"],
    "tp": ["--devices", "2", "--mesh_shape", "1,2", "--mesh_axes", "data,model",
           "--model_axis_mode", "tp", "--tp_min_dim", "128"],
    "spatial": ["--devices", "2", "--mesh_shape", "1,2", "--mesh_axes", "data,model",
                "--model_axis_mode", "spatial"],
    "one": ["--devices", "1"],
    "one_f32": ["--devices", "1", "--compute_dtype", "float32"],
}


def _real_step_memory(dev) -> dict:
    """A real unsharded bf16 DCGAN step at full width on this card, as the
    trainer builds it (no mesh, uint8 zeros decoded): the bytes the step's
    state and batch hold before its second step (what this process held
    before them left out), and its peak above them."""
    import torch

    from jckx_torch.configs import Config
    from jckx_torch.data.pipeline import decode_batch
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.train.state import create_dcgan_state
    from jckx_torch.train.steps import make_dcgan_train_step

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    cfg, geo = Config(), GANGeometry()
    gen = torch.Generator().manual_seed(cfg.seed)
    state = create_dcgan_state(cfg, Generator(geo, gen=gen).to(dev),
                               Discriminator(geo, gen=gen).to(dev))
    step = make_dcgan_train_step(cfg, geo)
    u8 = torch.zeros((TRAIN_BATCH, 64, 64, 3), dtype=torch.uint8, device=dev)
    step(state, decode_batch(u8, 64, torch.bfloat16))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(state, decode_batch(u8, 64, torch.bfloat16))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del state, step, u8
    torch.cuda.empty_cache()
    return {"argument_mb": (before - held) / 2**20, "temp_mb": (peak - before) / 2**20,
            "peak_mb": (peak - held) / 2**20}


def child_collectives(spec: dict) -> None:
    """One bf16 DCGAN step at full width (global batch 128) on a gloo pair
    of this card laid out as a (1, 2) mesh in ``spec["mode"]``, after one
    warm step: the mesh's collectives by kind (calls and bytes), which
    rank 0 saves to ``<out>.rank0.pt``."""
    import torch
    import torch.distributed as dist

    from jckx_torch.configs import Config
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.parallel import make_mesh
    from jckx_torch.train.state import create_dcgan_state
    from jckx_torch.train.steps import make_dcgan_train_step

    dev = _child_init("gloo")
    mesh = make_mesh((1, 2), ("data", "model"), device=dev)
    cfg, geo = Config(), GANGeometry()
    cfg.compute_dtype, cfg.max_learning_rate = "bfloat16", TRAIN_LR
    cfg.model_axis_mode = spec["mode"]
    gen = torch.Generator().manual_seed(0)
    state = create_dcgan_state(cfg, Generator(geo, gen=gen).to(dev),
                               Discriminator(geo, gen=gen).to(dev), mesh)
    real = (torch.rand(TRAIN_BATCH, 64, 64, 3, generator=torch.Generator().manual_seed(1))
            * 2 - 1).to(dev)
    step = make_dcgan_train_step(cfg, geo, mesh)
    step(state, real)
    mesh.stats.reset()
    step(state, real)
    torch.cuda.synchronize()
    if dist.get_rank() == 0:
        torch.save({k: {"calls": v["calls"], "bytes": v["bytes"]}
                    for k, v in mesh.stats.as_dict().items()}, f"{spec['out']}.rank0.pt")
    dist.destroy_process_group()


def phase_plan(tmp: str, dev) -> None:
    """``python -m jckx_torch plan --device cuda`` at the reference geometry
    (``PLAN_RUNS``, all at once): every report's memory read on the card
    and fitting; the TP and spatial reports' collectives per kind equal to
    a gloo pair's per bf16 step (``child_collectives``, beside them), and
    their bytes: the report counts a 16-bit tensor at its own width, gloo
    sends it as f32, so 2 x the report's bf16 bytes + its f32 bytes equal
    gloo's. The planned memory within 25 % of a real one-card step's
    temporaries, and the f32 FLOPs within 25 % of jckx's count. Launches no
    kernel: the planned step is differentiated."""
    import torch

    from jckx_torch.utils.comm import HLO_OPS  # the mesh's kinds → the report's op names

    launches = launch_counts()
    here = os.path.dirname(os.path.abspath(__file__))
    base = ["-m", "DCGAN", "-b", str(TRAIN_BATCH), "--image_size", "64", "--base_width", "64",
            "--device", "cuda"]
    procs = {name: subprocess.Popen([sys.executable, "-m", "jckx_torch", "plan", *base, *flags],
                                    cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, flags in PLAN_RUNS.items()}
    counted = os.path.join(tmp, "plan_collectives")
    pairs = {mode: _start_group("collectives", {"mode": mode, "out": f"{counted}_{mode}"}, 2)
             for mode in ("tp", "spatial")}
    reports = {}
    for name, p in procs.items():
        out, err = p.communicate(timeout=300)
        check(p.returncode == 0, f"plan {name} exited {p.returncode}:\n{err[-4000:]}")
        reports[name] = json.loads(out)
    for name, r in reports.items():
        mem = r["per_chip"]["memory"]
        check("error" not in mem and mem["fits"] and 0 < mem["peak_mb"] < mem["hbm_mb"]
              and "cuda" in r["backend"] and "CAVEAT" not in r["backend"],
              f"plan {name}: backend {r['backend']!r}, memory {mem}")
        ops = {op: (v["count"], v["bytes_total"]) for op, v in r["cross_shard_ops"].items()}
        print(f"plan {name} ({r['geometry']}, mesh {r['mesh']['shape']}): "
              f"{r['per_chip']['step_flops']:.4g} FLOP, memory {mem}, collectives (calls, "
              f"bytes) {ops}")
    for mode, ps in pairs.items():
        _join(ps, f"phase_plan, the {mode} pair's collectives")
        gloo = torch.load(f"{counted}_{mode}.rank0.pt", weights_only=False)
        ops = reports[mode]["cross_shard_ops"]
        for kind, op in HLO_OPS.items():
            mine = ops.get(op, {"count": 0, "bytes_total": 0, "by_dtype": {}})
            by = mine["by_dtype"]
            widened = 2 * by.get("bf16", {}).get("bytes", 0) + by.get("f32", {}).get("bytes", 0)
            check(mine["count"] == gloo[kind]["calls"] and widened == gloo[kind]["bytes"]
                  and set(by) <= {"bf16", "f32"},
                  f"plan {mode} {op}: {mine['count']} calls, {by} against the gloo pair's "
                  f"{gloo[kind]['calls']:g} calls of {gloo[kind]['bytes']:g} bytes per step")
        inventory = "; ".join(
            f"{op} {v['count']}: " + ", ".join(f"{d} {b['bytes']:,} B" for d, b in v["by_dtype"].items())
            for op, v in ops.items())
        print(f"plan {mode}: collectives per kind equal to a gloo pair's per bf16 step, bytes "
              f"equal once gloo's widening to f32 is undone: {inventory}")
    one = reports["one"]
    real = _real_step_memory(dev)
    mem = one["per_chip"]["memory"]
    check(abs(mem["temp_mb"] - real["temp_mb"]) <= 0.25 * real["temp_mb"],
          f"planned step temporaries {mem['temp_mb']} MB against a real step's "
          f"{real['temp_mb']:.1f} MB")
    print(f"planned memory of the unsharded bf16 step: peak {mem['peak_mb']} MB, arguments "
          f"{mem['argument_mb']} MB, temporaries {mem['temp_mb']} MB; a real one-card step "
          f"(torch.cuda.max_memory_allocated, less what this process held before it): peak "
          f"{real['peak_mb']:.1f} MB, arguments {real['argument_mb']:.1f} MB, temporaries "
          f"{real['temp_mb']:.1f} MB")
    flops = reports["one_f32"]["per_chip"]["step_flops"]
    ratio = flops / JCKX_PLAN_F32_FLOPS
    check(0.75 <= ratio <= 1.25, f"plan's f32 step FLOPs {flops:.4g} against jckx's "
                                 f"{JCKX_PLAN_F32_FLOPS:.4g}")
    print(f"the unsharded f32 step: {flops:.4g} FLOP (torch.utils.flop_counter's registry) "
          f"against jckx.plan's {JCKX_PLAN_F32_FLOPS:.4g} (XLA's cost analysis): {ratio:.4f}x")
    check(launch_counts() == launches, f"the planner launched a kernel in this process: "
                                       f"{launch_counts()} from {launches}")


def _pair_gaps(start: dict, got: dict, want: dict, grads: bool = True) -> dict:
    """A model-axis pair's first step (``got``) against the plain run's
    (``want``), per net: Adam deltas from ``start`` that differ by > 5 % of
    lr where the plain gradient clears 1 % of its leaf's maximum (flipped,
    and masked), the share the mask covers, and (with ``grads``) the
    largest per-leaf gap of the gradients in L2 relative to the plain
    run's. A ``ShardedAdam`` run keeps no whole gradient: ``grads`` off."""
    out = {}
    for i, net in enumerate(("G", "D")):
        flipped = masked = total = 0
        worst = (0.0, "")
        for k, g in want[net + "_grad"].items():
            mask = g.abs() > 1e-2 * g.abs().max() + 1e-12
            d = ((got[net][k] - start[i][k]) - (want[net][k] - start[i][k])).abs()
            flipped += int((d > 0.05 * TRAIN_LR)[mask].sum())
            masked += int(mask.sum())
            total += mask.numel()
            if grads:
                gap = float((got[net + "_grad"][k] - g).norm() / (g.norm() + 1e-30))
                worst = max(worst, (gap, k))
        out[net] = {"flipped": flipped, "masked": masked, "covered": masked / total,
                    "grad_gap": worst[0], "grad_gap_leaf": worst[1]}
    return out


def _gaps_text(gaps: dict) -> str:
    return "; ".join(
        f"{net}: {v['flipped']} of {v['masked']:,} masked Adam deltas off by > 5 % of lr "
        f"(covering {100 * v['covered']:.1f} %)"
        + (f", gradients at most {v['grad_gap']:.3g} apart in L2 ({v['grad_gap_leaf']})"
           if v["grad_gap_leaf"] else "") for net, v in gaps.items())


@contextlib.contextmanager
def keep_latest_of_step(step: int, dst: str):
    """While inside, copy ``latest.ckpt`` to ``dst`` when a trainer writes it
    at ``step``: the run overwrites it at every later eval."""
    import shutil

    from jckx_torch.checkpoint.checkpoint import BestMetricCheckpointer

    real = BestMetricCheckpointer.save_latest

    def save_latest(self, payload):
        path = real(self, payload)
        if payload.get("step") == step:
            shutil.copy(path, dst)
        return path

    BestMetricCheckpointer.save_latest = save_latest
    try:
        yield
    finally:
        BestMetricCheckpointer.save_latest = real


CHILDREN = {"train": child_train, "finetune": child_finetune, "collectives": child_collectives,
            "planes": child_planes, "mesh_graph": child_mesh_graph}


_LAP = [time.perf_counter()]


def lap(what: str) -> None:
    """Print the seconds since the previous lap (the script's time by phase)."""
    now = time.perf_counter()
    print(f"time: {what} {now - _LAP[0]:.1f} s", flush=True)
    _LAP[0] = now


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
    count_calibrations()

    kind, card = phase_environment()
    lap("start")
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dcgan_seed0.pt")
        geo = write_reference_checkpoint(path)
        svc, launches = phase_serve(path, geo)
        cgan_path = os.path.join(tmp, "cgan_seed0.pt")
        write_reference_checkpoint(cgan_path, conditional=True)
        csvc, cgan_launches = phase_serve_cgan(cgan_path, geo, dev)
        launches += cgan_launches + phase_serve_modes(path, cgan_path, svc, dev)
        launches += phase_http(svc, csvc)
        launches += phase_export(path, cgan_path, tmp, dev)
        phase_tools(path, os.path.join(tmp, "dcgan_bf16.pt2"), tmp, kind)
        launches += phase_mesh_serve(path, svc, dev)
    phase_serve_vs_plain(svc, dev)
    phase_serve_vs_plain(csvc, dev)
    del svc, csvc
    lap("build, serving, HTTP, export, tools, mesh serving")
    t = phase_timing(dev, card)
    mt = phase_moments(dev, card)
    bt = phase_bwd_timing(dev, card)
    bg = phase_biggan_kernels(dev, card)
    launches += bg["bn_act_launches"]
    phase_bn_relu_train(dev)
    phase_train_vs_cpu(dev)
    phase_train_vs_cpu(dev, conditional=True)
    phase_train_vs_cpu(dev, fused_prop=1)
    phase_train_vs_cpu(dev, conditional=True, fused_prop=1)
    phase_remat(dev, card)
    phase_sanitize(dev)
    phase_finetune_vs_cpu(dev)
    lap("kernel timings, card-vs-CPU steps, remat, sanitize, the fine-tune step against "
        "the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        step8 = os.path.join(tmp, "dcgan_step8.ckpt")
        with keep_latest_of_step(8, step8):
            tr, _, n = phase_train(tmp)
        launches += n + phase_watch(step8, os.path.join(tr.save_path, "latest.ckpt"), tmp)
        fused, _, n = phase_train(tmp, "DCGAN", ("--fused_prop", "1"), "smoke_fused_prop")
        check(fused.cfg.fused_prop == 1, "the trainer did not take --fused_prop 1")
        del fused
        launches += n + phase_profile_dir(tmp) + phase_jckx_ckpt(tmp)
        ctr, cevals, n = phase_train(tmp, "CGAN")
        launches += n + phase_evaluate(ctr, cevals, tmp) + phase_evaluate_int8(ctr, tmp)
        launches += phase_extra_metrics(ctr, tmp, dev) + phase_panel(tmp)
        launches += phase_finetune(ctr, tmp)
        lap("training, evaluate, panel, fine-tune")
        launches += phase_inference_graph(tmp, dev, tr, ctr)
        lap("phase_inference_graph")
        # the children below share the card: free the trainers' graphs first
        del tr, ctr
        gc.collect()
        torch.cuda.empty_cache()
        launches += phase_data_planes_alone(tmp)
        lap("phase_data_planes")
        # phase_mesh_graph's two worlds check bits beside phase_mesh's runs
        graphs = [start_mesh_graph(tmp, world) for world in MESH_GRAPH_WORLDS]
        launches += phase_mesh(tmp, dev, also={f"phase_mesh_graph, {world}": procs
                                               for world, (procs, _) in
                                               zip(MESH_GRAPH_WORLDS, graphs)})
        launches += phase_mesh_graph([out for _, out in graphs])
        launches += phase_mesh_model(tmp)
        lap("phase_mesh, phase_mesh_graph, phase_mesh_model")
        phase_plan(tmp, dev)
        lap("phase_plan")
    from jckx_torch.kernels import fused_bn_act as fba

    print(json.dumps({"kernels": [{
        "name": "fused_bn_act", "route": "cuda",
        "source": "jckx_torch/kernels/csrc/fused_bn_act.cu",
        "replaces": "jckx/kernels/fused_bn_act.py:120",
        "launches": launches,
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }, {
        "name": "bn_moments", "route": "cuda",
        "source": "jckx_torch/kernels/csrc/bn_moments.cu",
        "replaces": "none: jckx's _stats is XLA (jckx/kernels/fused_bn_act.py:66-71)",
        "launches": sum(MOMENTS_ON_PATHS),
        "max_rel_err_f64": mt["max_rel_err_f64"],
        "ms": mt["ms"], "plain_ms": mt["plain_ms"], "bound_ms": mt["bound_ms"], "bound_by": "bytes",
        "library_ms": mt["library_ms"], "finetune_step_ms": mt["finetune_step_ms"],
        "finetune_step_bound_ms": mt["finetune_step_bound_ms"],
        "finetune_step_plain_ms": mt["finetune_step_plain_ms"],
    }, {
        "name": "bn_relu_bwd", "route": "cuda",
        "source": "jckx_torch/kernels/csrc/bn_relu_bwd.cu",
        "replaces": "none: jckx's bn_relu_train VJP is jnp (jckx/ops/norm.py:134-156)",
        "launches": sum(BWD_ON_PATHS),
        "map": bt["layer"], "ms": bt["ms"], "plain_ms": bt["plain_ms"],
        "bound_ms": bt["bound_ms"], "bound_by": "bytes",
    }, {
        "name": "cbn_act", "route": "cuda",
        "source": "jckx_torch/kernels/csrc/cbn_act.cu",
        "replaces": "none: the JAX package has no conditional BN",
        "launches": bg["cbn_act"]["launches"], "launches_of": "one served BigGAN-128 replay",
        "ms": bg["cbn_act"]["ms"], "plain_ms": bg["cbn_act"]["plain_ms"],
        "bound_ms": bg["cbn_act"]["bound_ms"], "bound_by": "bytes",
    }, {
        "name": "up2_add", "route": "cuda",
        "source": "jckx_torch/kernels/csrc/up2_add.cu",
        "replaces": "none: the JAX package has no BigGAN",
        "launches": bg["up2_add"]["launches"], "launches_of": "one served BigGAN-128 replay",
        "ms": bg["up2_add"]["ms"], "plain_ms": bg["up2_add"]["plain_ms"],
        "bound_ms": bg["up2_add"]["bound_ms"], "bound_by": "bytes",
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--child":  # a child process of a phase
        count_calibrations()
        CHILDREN[sys.argv[2]](json.loads(sys.argv[3]))
    else:
        main()
