"""Smoke test of the PyTorch/CUDA port (``jckx_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``. It imports nothing of JAX or of the JAX package, and:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from the checkout's sources;
3. holds each kernel against its plain PyTorch version on the card
   (relu / leaky_relu(0.2) / none, bf16 and f32, the four generator
   shapes at serving's batch 512, at the DCGAN trainer's eval batch of 64
   and at the CGAN trainer's eval chunk of 500, and two ragged shapes):
   f32 within 1e-5 (an FMA against a separate multiply and add), bf16
   within one bf16 ulp plus that 1e-5;
4. serves requests through ``GeneratorService`` at the reference's full
   width (DCGAN 64², z 100, base width 64; then CGAN with K = 100, with
   and without ``labels``; weights drawn from a seed and saved in the
   reference ``.pt`` format), at batch 512 in bf16, with the launch
   counter reset just before and read just after each: it must read 4
   launches per rendered batch, and a labelled CGAN batch must equal its
   z rendered with the explicit one-hot. The served uint8 images for one
   z must be within 1 LSB of the plain route on the card, and equal to
   the plain route whose multiply-add is rounded once, as the kernel's;
5. times each generator layer's kernel against its bound (bytes over the
   H100 SXM's 3.35 TB/s), its plain version and ``F.batch_norm`` + ReLU,
   and the served images per second, beside the card's name and power
   limit, and profiles one served request (the card's busy share and its
   time by kernel);
6. holds one train step at full width (64², z 100, base width 64, batch
   16, f32, TF32 off; DCGAN, then CGAN with K = 100 and its four dropout
   masks) on the card against the same step on the CPU, from the same
   weights and the same draws (cuDNN deterministic): the six telemetry
   scalars within 3e-3, and Adam's deltas where the CPU's gradient clears 1 % of its leaf's
   maximum within 5 % of lr (tests/test_step_torch_parity.py:22-35) on
   all but 0.1 % of those elements; the differentiated step launches no
   kernel;
7. trains DCGAN, then CGAN, through the entry point
   (``jckx_torch.train.main``) at the reference geometry on 4096
   synthetic rows, bs128, bf16, lr 2e-4, one epoch of 32 steps with evals
   after steps 8, 16 and 32 (FID / IS, and CGAN's intra-FID, over the
   seeded InceptionV3; grids, checkpoints), with the launch counter reset
   just before and read just after: exactly 4 launches per eval for
   DCGAN (one G forward of 64), 8 for CGAN (1000 rows in chunks of 500),
   and none from the 32 steps. Losses and metrics must be finite and the
   artifacts written; the trained generator's eval sample, converted to
   uint8, is held against the plain routes as in 4; a second run with
   ``--resume`` must start at step 32 and train nothing;
8. scores the CGAN run's ``intra_fid/`` best checkpoint with
   ``jckx_torch.evaluate`` and its ``latest.ckpt`` with ``-t 1``: 8
   launches each, and the FID, IS and intra-FID the run logged at those
   steps within 1 % relative;
9. times training of each family beside the card's name and power limit:
   img/s on the host clock, one eval (the real features apart from the
   fake side), and a profiled window of 4 steps (busy share, top 10
   kernels; its device busy time / 4 is the step's time on the card);
10. holds the int8 convolution's card route (im2col + ``torch._int_mm``)
    against the exact f64 route on random int8 at batch 512 on every G
    layer (in_dim 100 and 200): bit-identical int32;
11. serves through the int8 sampler (DCGAN, and CGAN with labels), the
    sub-pixel one and the truncated one (t 0.7), and interpolates (16
    frames; int8 CGAN with a class morph): 4 launches per batch; renders
    bit-identical to the once-rounded plain route and within 1 LSB of
    ``bn_act_plain`` (the int8 path through the kernel's f32 variant);
    truncated z within [-t, t]; a strip byte-identical across calls and
    equal to the render of its latents; the f32 sub-pixel sampler within
    1 LSB of the default on the same z (the bf16 difference printed);
12. runs the HTTP daemon in this process on 127.0.0.1:0 (``/healthz``,
    ``/generate`` npy equal to ``sample()``, png by signature and IHDR size,
    ``/interpolate``, ``/metrics`` counters, the 400s and a 404, CGAN
    labels) and times one ``/generate`` of 4096 images end to end;
13. ``--watch``: a daemon on a copy of the DCGAN run's step-8 checkpoint,
    replaced atomically by the run's final ``latest.ckpt``; one poll moves
    ``/healthz`` to step 32, and ``/generate`` equals a fresh service;
14. ``evaluate --quant int8`` on the CGAN run: 8 launches, and the int8
    params it scores equal the served ones for the same calibration seed;
15. times served img/s by sampler (float, sub-pixel, int8), the int8
    convolution per G layer against bf16 cuDNN, and the f32 kernel per BN
    layer against its bound, beside the card's name and power limit;
16. exports sealed ``torch.export`` artifacts on the card (DCGAN bf16 at
    jckx's export batch of 64, CGAN with labels, DCGAN int8), loads each in
    a fresh ``ArtifactService``: 4 kernel launches per batch (the program's
    ``jckx_torch::normalize_act`` nodes), renders bit-identical to the
    service's on the same z (``rng.normal_from_seed``) and within 1 LSB of
    the plain route (int8: 4 LSB, 97.5 % exactly equal at batch 64, its
    flipped int8 activations printed per layer); one ``/generate`` through
    the daemon over a ``.pt2``, 4 launches per batch; export s, load s and
    the artifact's served img/s at batch 512 beside the float sampler's;
17. the tools through ``python -m jckx_torch``: ``convert`` .pt → checkpoint
    → .pt with equal tensors, ``inspect`` of every kind in a process that
    sees no card (``CUDA_VISIBLE_DEVICES=""``), ``doctor`` exiting 0 with
    the card's name and the kernel check;
18. ``evaluate --kid 1 --prdc 1 --eval_fast_stem 1`` on the CGAN run: 8
    launches; KID and precision / recall / density / coverage held against
    a float64 numpy computation on the same features and permutations, and
    PRDC again on the card on a pair whose manifolds overlap (half of the
    real features against the other half's first 1024 mixed with 1000
    fakes), where float64 puts precision, recall and coverage strictly
    between 0 and 1 and density above 0; the
    space-to-depth stem's features against the plain stem's (f32); times;
19. ``python -m jckx_torch panel --seeds 0,1 -m DCGAN --extra_metrics 1
    --eval_fast_stem 1`` at full width: one verdict with both seeds and
    ``best_kid`` / ``best_precision``; each child trainer logs its kernel
    launches (12: 4 per eval), which the script reads from its log;
20. holds ``ops/norm.bn_relu_train`` (the kernel's forward, the
    hand-written backward) against its plain version on the card, bf16, at
    the fine-tune's two largest stem maps and a Mixed_7c map (bs128, 299²):
    1 launch each, ``out`` bit-identical to the once-rounded plain route,
    statistics within 1e-5, dx / dgamma / dbeta within the tolerances
    ``phase_bn_relu_train`` states; times the kernel at the largest map
    against its bound, its plain version and ``F.batch_norm`` + ReLU;
21. holds one fine-tune step at 299², batch 8, f32, TF32 off on the card
    against the CPU (same weights, indices, crops, dropout mask): loss
    within 1e-3, SGD deltas within 10 % in norm per leaf (the fc's within
    1e-2 of its largest element), running statistics within 1e-3; 94
    launches;
22. fine-tunes InceptionV3 through ``python -m jckx_torch finetune``'s
    ``train()`` at 299², bs128, bf16, 2 epochs of 8 steps on 2560
    synthetic rows: 94 launches per step, none from the evals; finite
    losses; ``loss_bset`` / ``last_bset`` / ``train_state.npz`` and
    ``summary.json`` (``acc_bset.npz`` where top-1 rose above 0);
    ``--resume 1`` starts at epoch 2 and trains nothing; ``evaluate
    --metric_backbone loss_bset.npz`` on the CGAN run (8 launches, finite
    FID / IS); img/s, the step's device ms (profiler busy time / 4), busy
    share, top 10 kernels, FLOPs per step (``torch.utils.flop_counter``)
    and their share of the 989 TFLOP/s bf16 peak, eval and write seconds;
23. holds one full-width FusedProp step (``--fused_prop 1``; DCGAN, then
    CGAN with K = 100) on the card against the CPU with the tolerances of
    6, and ``d_gz2 == d_gz1`` on both;
24. ``--remat none|g|d|both``: one DCGAN step at bs128, bf16 from the same
    weights and draws under each mode: its parameters against ``none``'s
    (the masked-delta test of 6; max |diff| printed), the peak device
    memory of a step, and its device ms (profiler busy time / 4);
25. ``--sanitize``: a clean full-width step under anomaly detection equals
    the plain step bit for bit (cuDNN deterministic for the phase); a NaN
    in the real batch raises naming the backward function;
26. trains DCGAN with ``--fused_prop 1`` as in 7 (12 launches from the
    evals, none from the steps) and times its step against the faithful
    step on the same state, in turns of 4 steps: device ms and device
    events per step (profiler), host ms, img/s;
27. a short ``--profile_dir`` run (4 steps + 1 eval): one Chrome trace
    naming ``jckx_torch::normalize_act``, the kernel and
    ``aten::cudnn_convolution``;
28. the committed jckx ``.ckpt`` fixture (``tests/data/jckx_ckpt``, DCGAN
    with EMA and CGAN, 16²): served and rendered by ``evaluate``'s route
    through the kernel within 1 LSB of jckx's renders, ``evaluate`` end to
    end, ``convert`` to ``.pt`` and ``inspect``, and ``train --resume`` of
    jckx's run dir (one more eval, the port's ``latest.ckpt`` at step 8);
29. the data planes (``phase_data_planes``, in a child process of its own:
    ``child_planes`` says why): the native I/O library
    builds and loads (no numpy fallback on the card); a CIFAR-100 pickle of
    50,000 seeded rows is parsed and written to jckx's cache, then mapped
    (both times printed; equal arrays); real features of 10,000 mapped rows
    through the metrics engine's slab path (8 MB slabs, 4 of them) equal
    the per-batch path's (both timed); DCGAN trains 32 steps (K = 8) on
    4,096 mapped rows with ``--data_placement hbm`` and ``stream -w 4`` in
    turns (hbm, stream, stream, hbm), from the same weights with
    deterministic algorithms: parameters bit-identical, each plane's median
    img/s and host ms per step; a fifth, streamed run has one launch
    profiled (busy share, the slab's host→device copy ms and stream, which
    must run no kernel, and whether it overlapped compute); CGAN with
    ``--data_placement auto --hbm_data_budget 100000000`` streams the whole
    153.6 MB set, is cut by SIGTERM after 8 steps (``latest.ckpt``, the
    uploader stopped) and evaluated once; ``--dataset folder`` over 64 PNGs
    written by the port's own PNG writer trains 4 steps where PIL imports,
    and otherwise must refuse naming PIL; 4 launches per G forward of the
    phase's evals;
30. the mesh's data axis (``phase_mesh_serve``, ``phase_mesh``):
    ``GeneratorService`` over a local mesh ``[cuda:0, cuda:0]`` at bs512
    bf16 within 1 LSB of the unsharded service (≥ 99 % exact), 4 launches
    per device per batch; at full width, 8 steps and one eval each, f32, in
    child processes (``--child``): DCGAN on a NCCL world of one
    (``--mesh_shape 1 --multihost``, ``env://``) bit-identical to the plain
    run; DCGAN and CGAN on two gloo ranks of this card against the plain
    runs (telemetry within 3e-3, the masked deltas of 6), the kernel on
    each rank's rows at the eval; two fine-tune steps at 299² on the gloo
    pair (the first within 10 % in delta norm of one rank's); then the bf16
    step timed on the NCCL world of one (in turns against no mesh) and on
    the gloo pair, with the collectives per step by kind and their share;
31. the mesh's model axis (``phase_mesh_model``): at full width, 8 f32
    steps and one eval each, gloo pairs of child processes on this card as
    (1, 2) data x model meshes: DCGAN under ``tp``, ``spatial`` and
    ``spatial --spatial_replicate_grads 0``, CGAN under ``tp``, each first
    step against ``phase_mesh``'s plain run (telemetry within 3e-3, masked
    Adam deltas on all but 0.1 % of each net's, every leaf's gradient
    within 5 % in L2), ``0`` against ``1`` within 1e-6, every eval render
    through the kernel bit-identical to the once-rounded route, the TP
    checkpoint served; then the bf16 step of a TP pair and a spatial pair
    timed, with the collectives per step by kind and their host share; the
    first step's telemetry gap printed by field, and the spatial pair's
    first step against the plain step from the same weights and batch on
    the card (f32, and computed in f64) and on the CPU (f32: gloo, no
    cuDNN), by field;
32. the capacity planner (``phase_plan``): ``python -m jckx_torch plan
    --device cuda`` at the reference geometry in bf16 on an (8,) data mesh,
    (1, 2) ``tp`` (``--tp_min_dim 128``) and ``spatial`` meshes and one
    rank (bf16 and f32): every report's memory read on the card and
    fitting; TP's and spatial's collectives per kind equal to the gloo
    pairs' counts of 31, their bytes too once gloo's widening of 16-bit
    floats to f32 is undone; the floors beside the step's device ms of 9,
    the planned peak memory beside a real one-card step's, and the f32
    step's FLOPs beside jckx's XLA count (within 25 %);
33. the superstep (``phase_superstep``): the train step as one CUDA graph
    at full width, bs128, bf16. For DCGAN, CGAN, FusedProp, ``--remat
    both`` and cosine, 8 steps of a trainer through its superstep (the
    first eager, then the capture, 7 replays under
    ``torch.cuda.set_sync_debug_mode("error")``) equal 8 eager steps of a
    twin from the same seed bit for bit (telemetry, G, D, the EMA, Adam's
    moments and counts; cuDNN deterministic for the check); the fine-tune
    at 299²: one eager step, the capture and a launch of K = 8 replays
    equal 9 eager steps bit for bit, 94 launches counted per step either
    way. Then, recaptured under the default algorithms, eager and graph in
    turns of 4 steps on one state for DCGAN, CGAN and the fine-tune: host
    ms per step, device busy ms and share, device events per step, the
    capture's seconds and the graph pool's MB; in one fine-tune replay the
    profiler's ``bn_act`` kernels equal the 94 launches the superstep
    counted (a window that falls short, a record CUPTI dropped, is taken
    again, up to 3).
    Every other phase that trains through the trainer or the fine-tune's
    ``train()`` on one card, without a mesh or ``--sanitize``, runs its
    steps through the superstep too;
34. jckx's inference programs as CUDA graphs (``phase_inference_graph``,
    ``utils/graphs.GraphedProgram``): with cuDNN deterministic, a request
    of 4096 through the float, sub-pixel, int8, truncated (0.7) and CGAN
    samplers (labels, random classes) at bs512 bf16 and a DCGAN and a CGAN
    ``.pt2`` at batch 64 is one replay per batch after the capture, with
    no host synchronisation in a render, and equals the same object's
    eager route byte for byte; so do an HTTP ``/generate`` of 4096, the
    two trainers' eval renders, ``evaluate``'s renders, features and FID /
    IS / intra-FID on the CGAN run, and the features of 10,000 fakes; one
    replay's ``bn_act`` kernels in the profiler equal the launches it
    counted (float, int8); then, under the default algorithms, eager and
    graph in turns for the float and int8 samplers and a ``.pt2`` at batch
    512 (img/s, host ms per batch, busy share, device events per batch and
    per request, idle gaps, the copies' share) and for ``extract_features``
    of 10,000 rows (s), with each graph's capture s and pool MB.
    Every other phase that serves, renders an eval or extracts features on
    one card, without a mesh, replays these graphs too; its comparisons
    with the plain routes call the programs eagerly (``with_bn_act``);
35. prints a ``{"kernels": [...]}`` line, then, last, the
    ``{"ok": true, "device": {...}}`` line.

Any failed phase exits nonzero before the last line is printed. Without a
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
RAGGED = [(1000, 3), (8 * 7 * 7, 100)]                 # (rows, C)
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
BF16_FLOPS_PER_S = 989e12     # H100 SXM data sheet, dense bf16
# bn_relu_train's inputs at bs128, 299²: the two largest stem maps, and Mixed_7c's widest
FT_BN_SHAPES = [(64, 147), (32, 149), (448, 8)]  # (C, side)
DATA_ROWS = 50_000             # CIFAR-100's train split, planted as its pickle
PLANE_ROWS = 4096              # the rows the two DCGAN planes train on: 32 steps at bs128
FEATURE_ROWS = 10_000          # real features through the slab path and the per-batch path
FEATURE_SLAB_BYTES = 8 << 20   # 10,000 rows of 32² (30.7 MB) in 4 slabs of 10 batches
# device kernels by kind, for the profiles: the first kind whose words a name holds
KERNEL_KINDS = [("fused bn_act", ("bn_act",)),
                ("pooling", ("pool",)),
                ("int8 GEMM (_int_mm)", ("gemm_s8", "s8s8", "imma")),
                ("convolution (cuDNN)", ("xmma", "cutlass", "cudnn", "conv", "dgrad", "wgrad",
                                         "implicit_gemm", "nhwc", "nchw")),
                ("copy / cast", ("copy", "Memcpy", "Memset")),
                ("reduction", ("reduce_kernel",)),
                ("elementwise", ("elementwise", "foreach", "multi_tensor"))]


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


def phase_kernel_vs_plain(dev) -> float:
    """Kernel against its plain version on the same inputs. → max |err|."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba

    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [(n * s * s, c) for n in (BATCH, EVAL_BATCH, CGAN_CHUNK) for s, c in G_LAYERS] + RAGGED
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
    for n in (BATCH, EVAL_BATCH, CGAN_CHUNK):
        for s, c in G_LAYERS:
            x = torch.randn(n, c, s, s, generator=g, device=dev).to(
                torch.bfloat16, memory_format=torch.channels_last)
            scale = torch.rand(c, generator=g, device=dev) + 0.5
            bias = torch.randn(c, generator=g, device=dev)
            y = fba.bn_act(x, scale, bias, act="relu")
            ref = fba.bn_act_plain(x, scale, bias, act="relu")
            torch.cuda.synchronize()
            check(y.is_contiguous(memory_format=torch.channels_last), "bn_act output not channels_last")
            check(bf16_ulp_ok(y, ref), f"bn_act vs bn_act_plain at {n}x{s}x{s}x{c}")
    print(f"kernel vs plain: {len(shapes) * 6 + 3 * len(G_LAYERS)} comparisons passed, "
          f"max |err| {worst} (f32 <= 1e-5, bf16 <= 1 ulp + 1e-5)")
    return worst


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
    fba.LAUNCHES = 0
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
    classes) against the plain path on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(123)
    z = torch.randn(BATCH, svc.geo.z_dim, generator=g, device=dev)
    args = (z, torch.randint(0, svc.num_classes, (BATCH,), generator=g, device=dev)) \
        if svc.conditional else (z,)
    check_u8_agree(lambda: svc.render(*args),
                   "served CGAN uint8 images" if svc.conditional else "served uint8 images")


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
        lib2 = device_ms(_addcmul_relu, x2ds)
        moved = 2 * nbytes + 2 * c * 4           # x read, y written, inv + shift read
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = 3 * rows * c / F32_FLOPS_PER_S * 1e3  # FMA + activation, f32
        bound = max(bytes_ms, ops_ms)
        rows_out.append({"layer": f"{s}x{s}x{c}", "rows": rows, "C": c, "ms": ms, "bound_ms": bound,
                         "bytes_ms": bytes_ms, "ops_ms": ops_ms, "plain_ms": plain,
                         "bn_act_ms": full, "library_ms": lib, "addcmul_relu_ms": lib2})
        print(f"  layer {s:>2}x{s:<2}x{c:<3} kernel {ms * 1e3:8.2f} us  bound {bound * 1e3:6.2f} us "
              f"({100 * bound / ms:5.1f} %)  plain {plain * 1e3:8.2f} us  bn_act (stats + kernel) "
              f"{full * 1e3:8.2f} us  F.batch_norm + relu {lib * 1e3:8.2f} us  the same function "
              f"in two library calls (addcmul, relu_) {lib2 * 1e3:8.2f} us   [{card}]")
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
    out = {k: sum(r[k] for r in rows_out)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "addcmul_relu_ms")}
    print(f"per G forward at batch {BATCH}, bf16, the four BN layers: kernel {out['ms']:.5f} ms, "
          f"bound {out['bound_ms']:.5f} ms, plain {out['plain_ms']:.5f} ms, F.batch_norm + relu "
          f"{out['library_ms']:.5f} ms, addcmul + relu_ {out['addcmul_relu_ms']:.5f} ms   [{card}]")
    out["bound_by"] = "bytes" if all(r["bytes_ms"] >= r["ops_ms"] for r in rows_out) else "operations"
    return out


def _addcmul_relu(x2d, inv, shift):
    """The kernel's function in two library calls: ``torch.addcmul(shift,
    x2d, inv)`` into a tensor of x's dtype (f32 arithmetic), then ``relu_``."""
    import torch

    return torch.addcmul(shift, x2d, inv, out=torch.empty_like(x2d)).relu_()


def profile_window(run, what: str, card: str, top_n: int = 10) -> dict:
    """``run()`` under ``torch.profiler``: the card's busy share of the
    window and its time by kernel (the ``top_n`` largest), printed.
    Informational: prints "not measured" where the profiler sees no device
    activity. → the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    # device events, without the profiler's user annotations on the device
    # timeline ("Optimizer.step#Adam.step"), which span idle time too
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and "#" not in e.name]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    if not spans:
        print(f"profiled {what}: the profiler saw no device activity; busy share not measured"
              f"   [{card}]")
        return {}
    window = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    idle = []  # the card's idle gaps between device events, in us
    for s, e in spans[1:]:  # union of the device intervals
        if s > hi:
            busy, lo = busy + hi - lo, s
            idle.append(s - hi)
        hi = max(hi, e)
    busy += hi - lo
    long_gaps = [g for g in idle if g > 10.0]
    by_name, by_kind = {}, {}
    for e in kernels:
        dt = e.time_range.end - e.time_range.start
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + dt, k + 1)
        kind = next((kind for kind, keys in KERNEL_KINDS if any(w in e.name for w in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + dt
    total = sum(t for t, _ in by_name.values())
    print(f"profiled {what}: window {window / 1e3:.3f} ms, card busy {busy / 1e3:.3f} ms "
          f"({100 * busy / window:.1f} %, idle {100 - 100 * busy / window:.1f} %), "
          f"{len(kernels)} device events; {len(long_gaps)} idle gaps over 10 us between them, "
          f"{sum(long_gaps) / 1e3:.3f} ms in all   [{card}]")
    print("  by kind: " + ", ".join(f"{kind} {100 * t / total:.1f} %"
                                    for kind, t in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    for name, (t, k) in top:
        print(f"  {t / 1e3:8.3f} ms {100 * t / total:5.1f} %  x{k:<4} {name[:90]}")
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3, "events": len(kernels),
            "gaps_over_10us": len(long_gaps), "gap_ms_over_10us": sum(long_gaps) / 1e3,
            "calls": {name: k for name, (_, k) in by_name.items()},
            "by_kind": {kind: t / 1e3 for kind, t in by_kind.items()},
            "top": [(name[:90], t / 1e3, k) for name, (t, k) in top]}


def phase_profile(svc, card: str) -> None:
    """One served request of 8 batches under ``torch.profiler``."""
    svc.sample(BATCH, seed=0)  # warm
    profile_window(lambda: svc.sample(8 * BATCH, seed=99),
                   f"request of {8 * BATCH} images at batch {BATCH}, bf16", card)


def phase_train_vs_cpu(dev, conditional: bool = False, fused_prop: int = 0) -> None:
    """One full-width train step (DCGAN, or CGAN with K = 100; the faithful
    step, or FusedProp with ``fused_prop``) on the card against the CPU,
    from the same weights, draws, masks and labels, in f32 with TF32 off
    (set in ``main``), cuDNN deterministic on the card: its default
    algorithms sum in an order that changes from run to run, and one
    masked element of CGAN's ``G.norm1.weight`` (499 masked, so none may
    flip) changed sign in 2 of 7 such runs on an H100, in none of 3 with
    deterministic algorithms."""
    import torch

    from jckx_torch.configs import Config
    from jckx_torch.data.pipeline import one_hot
    from jckx_torch.kernels import fused_bn_act as fba
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
        before = fba.LAUNCHES
        t0 = time.perf_counter()
        with _deterministic_cudnn():
            m = step(state, real.to(device), *extra,
                     StepDraws(**{k: v.to(device) for k, v in draws.items()}))
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(fba.LAUNCHES == before, f"the differentiated train step on {device} launched the kernel")
        params = {**{"G." + k: v.detach().cpu() for k, v in G.state_dict().items()},
                  **{"D." + k: v.detach().cpu() for k, v in D.state_dict().items()}}
        grads = {**{"G." + k: q.grad.cpu() for k, q in G.named_parameters()},
                 **{"D." + k: q.grad.cpu() for k, q in D.named_parameters()}}
        out.append(({k: float(v) for k, v in m.items()}, params, grads, dt))
    (mc, pc, gc, dtc), (mg, pg, _, dtg) = out
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
          f"parameters); 0 kernel launches; first step {dtc:.2f} s on the CPU, {dtg:.2f} s on the card"
          + ("; d_gz2 == d_gz1 on both" if fused_prop else ""))


def _run_dir_args(tmp: str, model: str, run: str = "") -> list:
    return ["--save_root", os.path.join(tmp, "save"), "--data_dir", os.path.join(tmp, "data"),
            "-pm", run or f"smoke_{model.lower()}"]


def phase_train(tmp: str, model: str = "DCGAN", flags: tuple = (), run: str = ""):
    """The main training path through the entry point, for ``model``, with
    the train flags ``flags`` in run dir ``run``. → (trainer, its launch
    records, its eval records, kernel launches during the run)."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.serve import tanh_to_u8
    from jckx_torch.train import main as tmain

    where = _run_dir_args(tmp, model, run)
    argv = ["-m", model, "--dataset", "synthetic", "-b", str(TRAIN_BATCH), "-e", "1",
            "-mlr", str(TRAIN_LR), "--log_every", "8", "--eval_every", "16"] + list(flags) + where
    fba.LAUNCHES = 0
    t0 = time.perf_counter()
    tr = tmain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
    with open(os.path.join(tr.save_path, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "step_ms" in r]
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
          f"{TRAIN_BATCH}, bf16, through jckx_torch.train.main in "
          f"{wall:.1f} s (data, backbone, real features and 3 evals included): evals after "
          f"{tr.evals}, {launches} kernel launches = {per_eval} per eval ({forwards} G forward(s) "
          f"of {min(n_eval, CGAN_CHUNK) if conditional else n_eval} rows), 0 from the steps; last "
          f"losses D {tr._resumed_losses[-1][0]:.4f} G {tr._resumed_losses[-1][1]:.4f}; "
          + ", ".join(" ".join(f"{k} {r[k]:.4f}" for k in metrics) + f" @ {r['step']}" for r in evals))
    # the kernel at the eval's shapes, on the trained weights, against the plain route
    check(tr.cfg.sample_count == EVAL_BATCH, f"sample_count {tr.cfg.sample_count}")
    before = fba.LAUNCHES
    check_u8_agree(lambda: tanh_to_u8(tr.sample_eval()),
                   f"{model} eval sample of {n_eval} trained images (uint8)")
    check(fba.LAUNCHES == before + per_eval, "the eval sample did not launch the kernel")

    before = fba.LAUNCHES
    tr2 = tmain.main(["--resume"] + where)
    MainLogger.reset()
    check(tr2.conditional == conditional and tr2.state.step == 32 and tr2.evals == []
          and fba.LAUNCHES == before,
          f"--resume started at step {tr2.state.step} and evaluated {tr2.evals}")
    print(f"{model} --resume on the same run dir: restored step 32, nothing left to train")
    return tr, steps, evals, launches


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
    fba.LAUNCHES = 0
    scored = [evaluate.main(["--ckpt", os.path.join(sub, pt), "--dataset", "synthetic"] + where[:4])]
    launches = [fba.LAUNCHES]
    MainLogger.reset()
    fba.LAUNCHES = 0
    scored.append(tmain.main(["-t", "1"] + where))
    launches.append(fba.LAUNCHES)
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


def phase_train_timing(tr, steps, tmp: str, card: str) -> dict:
    """Training numbers beside the card's name and power limit."""
    import torch

    from jckx_torch.data.pipeline import decode_batch, one_hot
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.metrics.metrics import Metrics

    model = "CGAN" if tr.conditional else "DCGAN"
    rates = [r["images_per_sec"] for r in steps[1:]]
    step_ms = [r["step_ms"] for r in steps[1:]]
    print(f"{model} train img/s at batch {TRAIN_BATCH}, bf16, host clock: median "
          f"{statistics.median(rates):.1f} over the {len(rates)} launches after the first (min "
          f"{min(rates):.1f}, max {max(rates):.1f}); {statistics.median(step_ms):.3f} ms per step"
          f"   [{card}]")
    real = decode_batch(tr.images_dev[:TRAIN_BATCH], tr.cfg.image_size, tr.cd)
    extra = (one_hot(tr.labels_dev[:TRAIN_BATCH], tr.num_classes),) if tr.conditional else ()
    n = 8
    for _ in range(3):
        tr.step_fn(tr.state, real, *extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        tr.step_fn(tr.state, real, *extra)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / n

    t0 = time.perf_counter()
    Metrics(tr.data_pre.metric_source, tr.cfg, backbone=tr.metric.backbone,
            batch_size=tr.cfg.eval_batch_size, compute_dtype=tr.cd,
            cache_dir=os.path.join(tmp, f"fresh_cache_{model}"), num_classes=tr.num_classes,
            device=tr.device)
    real_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fake = tr.sample_eval()
    feats = tr.metric.extract_features(fake)
    tr.metric.inception_score(logits=feats)
    tr.metric.fid(features=feats)
    if tr.conditional:
        tr.metric.intra_fid(features=feats)
    fake_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr._evaluate(tr.state.step, [], [])
    eval_s = time.perf_counter() - t0
    print(f"{model} eval: real features of {tr.n_data} images {real_s:.3f} s (once per run, then "
          f"cached); {fake.shape[0]} fakes sampled + features + IS + FID"
          f"{' + intra-FID' if tr.conditional else ''} {fake_s:.3f} s; one whole trainer eval with "
          f"its checkpoints and grids {eval_s:.3f} s   [{card}]")

    k = 4  # steps profiled (cut from 8 for the script's time)
    prof = profile_window(lambda: [tr.step_fn(tr.state, real, *extra) for _ in range(k)],
                          f"{k} {model} train steps at batch {TRAIN_BATCH}, bf16", card)
    # the card's busy time, not CUDA events: the host cannot enqueue the
    # steps ahead of the card, so events around them time the host
    card_ms = prof["busy_ms"] / k if prof else None
    print(f"one {model} train step at batch {TRAIN_BATCH}, bf16: "
          + (f"{card_ms:.3f} ms" if prof else "not measured")
          + f" on the card (profiler busy time / {k}), {host_ms:.3f} ms on the host clock   [{card}]")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"peak device memory {peak:.2f} GiB")
    MainLogger.reset()  # the fresh engine above bound the logger to this run's dir
    out = {"model": model, "card": card, "batch": TRAIN_BATCH, "dtype": "bfloat16",
           "img_per_s_host_median": statistics.median(rates), "step_ms_card": card_ms,
           "step_ms_host": host_ms, "eval_fakes": fake.shape[0],
           "real_features_s": real_s, "fake_side_s": fake_s, "eval_s": eval_s,
           "profile": prof, "peak_gib": peak}
    print("train_numbers " + json.dumps(out))
    return out


def int8_layers(in_dim: int) -> list:
    """G's ConvTranspose layers at 64², base width 64: (Cin, Cout, input
    side, stride, padding)."""
    return [(in_dim, 512, 1, 1, 0), (512, 256, 4, 2, 1), (256, 128, 8, 2, 1),
            (128, 64, 16, 2, 1), (64, 3, 32, 2, 1)]


def phase_int8_exact(dev) -> None:
    """The int8 convolution's card route (im2col + ``torch._int_mm``)
    against the exact f64 route on the card, on random int8 at the serving
    shapes (batch 512) of every G layer, DCGAN's and CGAN's: bit-identical
    int32."""
    import torch

    from jckx_torch.ops import quant as tquant

    g = torch.Generator(device=dev).manual_seed(8)
    n = 0
    for in_dim in (100, 200):
        for cin, cout, hw, stride, pad in int8_layers(in_dim):
            x = torch.randint(-127, 128, (BATCH, cin, hw, hw), generator=g, device=dev,
                              dtype=torch.int8).contiguous(memory_format=torch.channels_last)
            w = torch.randint(-127, 128, (cin, cout, 4, 4), generator=g, device=dev, dtype=torch.int8)
            got = tquant.conv_transpose2d_int8(x, w, stride, pad)
            want = tquant.conv_transpose2d_int8_exact(x, w, stride, pad)
            torch.cuda.synchronize()
            check(got.dtype == torch.int32 and got.shape == want.shape and torch.equal(got, want),
                  f"int8 route vs exact: {cin}->{cout} at {hw}x{hw} differs")
            n += 1
    print(f"int8 ConvTranspose, _int_mm route vs exact f64 route at batch {BATCH}: {n} layers "
          f"(in_dim 100 and 200) bit-identical int32")


def phase_serve_modes(path: str, cgan_path: str, svc, dev):
    """int8 (DCGAN and CGAN with labels), sub-pixel and truncated serving,
    and interpolation, with the launch counter reset just before the
    requests and read just after. → (services by mode, launches)."""
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
    fba.LAUNCHES = 0
    out = [s.sample(n, labels=lab, seed=seed) for s, n, lab, seed in requests]
    walks = [trunc.interpolate(3, 5, steps=16), trunc.interpolate(3, 5, steps=16),
             cq.interpolate(3, 5, steps=16, label_a=3, label_b=17)]
    launches = fba.LAUNCHES
    batches = sum(math.ceil(n / BATCH) for _, n, _, _ in requests) + len(walks)
    check(launches == 4 * batches, f"{launches} kernel launches for {batches} batches of the "
                                   f"int8, sub-pixel and truncated samplers, want {4 * batches}")
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
    return {"int8": q, "int8_cgan": cq, "subpixel": sub}, launches


def count_int8_flips(render) -> list:
    """Per quantized layer of ``render()``'s int8 forward, the int8
    activations that differ between the kernel route and ``bn_act_plain``
    (``(flipped, total)``)."""
    import torch

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


def phase_http(svc, csvc, card: str):
    """The HTTP daemon on the card, in this process. → (launches, numbers)."""
    import struct

    from jckx_torch.kernels import fused_bn_act as fba

    d = Daemon(svc)
    try:
        fba.LAUNCHES = 0
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
        # one large request end to end, on the host clock (npy body, 48 MiB)
        walls = []
        for i in range(3):
            t0 = time.perf_counter()
            code, _, body = d("/generate", {"n": 4096, "seed": 100 + i, "format": "npy"})
            walls.append(time.perf_counter() - t0)
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
    batches = 2 * 2 + 1 + 2 * 1 + 3 * 8 + 2 * 2
    check(launches == 4 * batches, f"{launches} kernel launches in the HTTP phase, want {4 * batches}")
    ms = sorted(walls)[1] * 1e3
    print(f"HTTP daemon on the card: /healthz, /generate npy (== sample()), png ({side}x{side}), "
          f"/interpolate (== interpolate()), /metrics counters, the 400s and a 404, CGAN labels; "
          f"{launches} kernel launches. /generate of 4096 images (npy, end to end): median "
          f"{ms:.1f} ms over 3, {4096 / ms * 1e3:.1f} img/s   [{card}]")
    return launches, {"generate_4096_ms": ms, "generate_4096_ms_all": walls}


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
    fba.LAUNCHES = 0
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
    from jckx_torch.kernels import fused_bn_act as fba
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
    fba.LAUNCHES = 0
    try:
        res = evaluate.main(["--ckpt", latest, "--dataset", "synthetic", "--quant", "int8",
                             "--calib_seed", "3"] + _run_dir_args(tmp, "CGAN")[:4])
    finally:
        evaluate.make_sampler = real
    launches = fba.LAUNCHES
    MainLogger.reset()
    served = GeneratorService(latest, quant="int8", seed=3).params
    check(launches == 8 and res["quant"] == "int8" and res["n"] == 10 * CGAN_CLASSES,
          f"evaluate --quant int8: {launches} launches, {res}")
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


def served_rate(svc) -> float:
    """Median img/s of 5 requests of 8 batches, on the host clock."""
    n = 8 * BATCH
    svc.sample(BATCH, seed=0)  # warm
    walls = []
    for i in range(5):
        t0 = time.perf_counter()
        svc.sample(n, seed=1 + i)
        walls.append(time.perf_counter() - t0)
    return sorted(n / w for w in walls)[2]


def phase_modes_timing(svc, modes, dev, card: str) -> dict:
    """Served img/s by sampler; per G layer the int8 route's convolution
    against the bf16 cuDNN one; the f32 kernel per BN layer against its
    bound."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.ops import quant as tquant
    from jckx_torch.ops.conv import conv_transpose2d

    rates = {"float": served_rate(svc), "subpixel": served_rate(modes["subpixel"]),
             "int8": served_rate(modes["int8"]), "float_again": served_rate(svc)}
    print("served img/s at batch 512, median of 5 requests of 4096 (host clock): "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()) + f"   [{card}]")
    g = torch.Generator(device=dev).manual_seed(2)
    convs = []
    for cin, cout, hw, stride, pad in int8_layers(100):
        nbytes = BATCH * cin * hw * hw
        xs = rotation(lambda: torch.randint(-127, 128, (BATCH, cin, hw, hw), generator=g, device=dev,
                                            dtype=torch.int8).contiguous(memory_format=torch.channels_last),
                      nbytes)
        w = torch.randint(-127, 128, (cin, cout, 4, 4), generator=g, device=dev, dtype=torch.int8)
        xb = [(x.to(torch.bfloat16),) for x in xs]
        wb = w.to(torch.bfloat16)
        int8_ms = device_ms(lambda x: tquant.conv_transpose2d_int8(x, w, stride, pad), [(x,) for x in xs])
        bf16_ms = device_ms(lambda x: conv_transpose2d(x, wb, stride, pad), xb)
        sub_ms = device_ms(lambda x: conv_transpose2d(x, wb, stride, pad, subpixel=True), xb)
        convs.append({"layer": f"{cin}->{cout} {hw}->{hw * 2 if stride == 2 else 4}", "int8_ms": int8_ms,
                      "bf16_cudnn_ms": bf16_ms, "bf16_subpixel_ms": sub_ms})
        print(f"  convT {cin:>3}->{cout:<3} at {hw:>2}x{hw:<2}: int8 (_int_mm route) {int8_ms * 1e3:9.2f} us, "
              f"bf16 cuDNN {bf16_ms * 1e3:9.2f} us, bf16 sub-pixel {sub_ms * 1e3:9.2f} us   [{card}]")
    f32 = []
    for s, c in G_LAYERS:
        rows = BATCH * s * s
        nbytes = rows * c * 4
        x2ds = rotation(lambda: torch.randn(rows, c, generator=g, device=dev), nbytes)
        inv = torch.rand(c, generator=g, device=dev) + 0.5
        shift = torch.randn(c, generator=g, device=dev)
        ms = device_ms(lambda x: fba.normalize_act(x, inv, shift, "relu"), [(x,) for x in x2ds])
        plain = device_ms(lambda x: fba.normalize_act_plain(x, inv, shift, "relu"), [(x,) for x in x2ds])
        bytes_ms = (2 * nbytes + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
        ops_ms = 3 * rows * c / F32_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        f32.append({"layer": f"{s}x{s}x{c}", "ms": ms, "bound_ms": bound, "plain_ms": plain})
        print(f"  f32 kernel {s:>2}x{s:<2}x{c:<3} {ms * 1e3:8.2f} us  bound {bound * 1e3:6.2f} us "
              f"({100 * bound / ms:5.1f} %)  plain {plain * 1e3:8.2f} us   [{card}]")
    modes["int8"].sample(BATCH, seed=0)  # warm
    prof = profile_window(lambda: modes["int8"].sample(8 * BATCH, seed=99),
                          f"int8 request of {8 * BATCH} images at batch {BATCH}", card)
    out = {"card": card, "batch": BATCH, "served_img_per_s": rates, "int8_convs": convs,
           "f32_bn_act": f32, "int8_profile": prof}
    print("serve_modes " + json.dumps(out))
    return out


def phase_export(path: str, cgan_path: str, svc, tmp: str, dev, card: str):
    """Sealed artifacts exported on the card from the seed-0 checkpoints,
    each loaded in a fresh ``ArtifactService``, the launch counter reset
    just before each artifact request and read just after. → (the
    numbers, launches)."""
    import numpy as np
    import torch

    from jckx_torch import rng
    from jckx_torch.export import ArtifactService, export_generator
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.serve import GeneratorService

    labels = [SERVE_LABELS[i % len(SERVE_LABELS)] for i in range(EXPORT_BATCH)]
    lab_dev = torch.tensor(labels, device=dev)
    numbers, arts, launches = {}, {}, 0
    for what, src, quant, cond in (("dcgan_bf16", path, None, False),
                                   ("cgan_bf16", cgan_path, None, True),
                                   ("dcgan_int8", path, "int8", False)):
        dst = os.path.join(tmp, f"{what}.pt2")
        t0 = time.perf_counter()
        info = export_generator(src, dst, quant=quant)  # the defaults: cuda, batch 64, bf16
        export_s = time.perf_counter() - t0
        check(info["platforms"] == ["cuda"] and info["batch_size"] == EXPORT_BATCH
              and info["conditional"] == cond and info["quant"] == quant, f"{what}: {info}")
        t0 = time.perf_counter()
        art = arts[what] = ArtifactService(dst)
        load_s = time.perf_counter() - t0
        ref = GeneratorService(src, batch_size=EXPORT_BATCH, quant=quant)
        exact, worst = [], 0
        for seed in (0, 1, 7):
            fba.LAUNCHES = 0
            got = art.sample(EXPORT_BATCH, labels=labels if cond else None, seed=seed)
            n = fba.LAUNCHES
            check(n == 4, f"{what}: {n} kernel launches for one batch of the artifact, want 4")
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
        numbers[what] = {"export_s": export_s, "load_s": load_s, "bytes": info["bytes"],
                         "vs_plain_max_lsb": worst, "vs_plain_exact": min(exact)}
        print(f"artifact {what} (batch {EXPORT_BATCH}): exported in {export_s:.2f} s "
              f"({info['bytes']} bytes), loaded in {load_s:.2f} s; seeds 0, 1, 7: 4 kernel launches "
              f"each, bit-identical to the service on rng.normal_from_seed's z; vs the plain route "
              f"max {worst} LSB, {100 * min(exact):.4f} % exactly equal   [{card}]")
    d = Daemon(arts["dcgan_bf16"])
    try:
        code, _, body = d("/healthz")
        check(code == 200 and json.loads(body)["batch_size"] == EXPORT_BATCH, f"/healthz {code}")
        fba.LAUNCHES = 0
        code, _, body = d("/generate", {"n": 600, "seed": 5, "format": "npy"})
        n = fba.LAUNCHES
        want = 4 * math.ceil(600 / EXPORT_BATCH)
        check(n == want, f"/generate of 600 over a .pt2: {n} kernel launches, want {want}")
        launches += n
        check(code == 200 and _npy(body).tobytes()
              == arts["dcgan_bf16"].sample(600, seed=5).tobytes(),
              "/generate over a .pt2 differs from the artifact's sample()")
        check(d("/interpolate", {"seed_a": 1, "seed_b": 2})[0] == 400,
              "/interpolate over a .pt2 is not a 400")
    finally:
        d.close()
    # served img/s at batch 512: the artifact beside the float sampler, in turns
    dst = os.path.join(tmp, "dcgan_bf16_512.pt2")
    t0 = time.perf_counter()
    export_generator(path, dst, batch_size=BATCH)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = ArtifactService(dst)
    load_s = time.perf_counter() - t0
    rates = {"float": served_rate(svc), "artifact": served_rate(art),
             "artifact_again": served_rate(art), "float_again": served_rate(svc)}
    prof = profile_window(lambda: art.sample(8 * BATCH, seed=99),
                          f"artifact request of {8 * BATCH} images at batch {BATCH}", card)
    numbers["batch_512"] = {"export_s": export_s, "load_s": load_s, "served_img_per_s": rates,
                            "profile": prof}
    print(f"/generate over the DCGAN .pt2: 600 npy equal to sample(), {want} kernel launches, "
          f"/interpolate a 400. At batch "
          f"{BATCH}: exported in {export_s:.2f} s, loaded in {load_s:.2f} s; served img/s (median "
          f"of 5 requests of 4096, host clock): " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + f"   [{card}]")
    print("export_numbers " + json.dumps({"card": card, **numbers}))
    return numbers, launches


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


def phase_extra_metrics(tr, tmp: str, dev, card: str) -> int:
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_kid(real, fake, **kw)
        seen["kid_s"] = time.perf_counter() - t0
        return out

    def mm_spy(real, fake, **kw):
        seen["prdc"] = (np.asarray(real), np.asarray(fake), kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_mm(real, fake, **kw)
        seen["prdc_s"] = time.perf_counter() - t0
        return out

    latest = os.path.join(tr.save_path, "latest.ckpt")
    extra.kid, extra.manifold_metrics = kid_spy, mm_spy
    fba.LAUNCHES = 0
    try:
        t0 = time.perf_counter()
        res = evaluate.main(["--ckpt", latest, "--dataset", "synthetic", "--kid", "1", "--prdc", "1",
                             "--eval_fast_stem", "1"] + _run_dir_args(tmp, "CGAN")[:4])
        wall = time.perf_counter() - t0
    finally:
        extra.kid, extra.manifold_metrics = real_kid, real_mm
    launches = fba.LAUNCHES
    MainLogger.reset()
    keys = ("kid", "kid_std", "precision", "recall", "density", "coverage")
    check(launches == 8 and all(math.isfinite(res[k]) for k in keys + ("fid", "intra_fid")),
          f"evaluate --kid --prdc --eval_fast_stem: {launches} launches, {res}")
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    overlap = extra.manifold_metrics(a, b, device=dev)
    overlap_s = time.perf_counter() - t0
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
    stem = net.Conv2d_1a_3x3
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        stem_ms = device_ms(lambda v: stem(v), [(xb,)])
        s2d_ms = device_ms(lambda v: stem.stem_s2d(v), [(xb,)])
    out = {"card": card, "evaluate_s": wall, "kid_s": seen["kid_s"], "prdc_s": seen["prdc_s"],
           "n_real": len(real), "n_fake": len(fake), "kid_rel_gap_f64": kid_gap,
           "prdc_abs_gap_f64": gaps, "s2d_rel_diff_f32": rel, "s2d_rel_diff_bf16": rel16,
           "stem_ms_bs64_bf16": stem_ms, "stem_s2d_ms_bs64_bf16": s2d_ms,
           "prdc_overlap": overlap, "prdc_overlap_f64": ref_overlap, "prdc_overlap_s": overlap_s}
    print(f"evaluate --kid 1 --prdc 1 --eval_fast_stem 1 on the CGAN run's latest.ckpt: "
          f"{wall:.3f} s, {launches} kernel launches; kid {res['kid']:.6g} ± {res['kid_std']:.3g} "
          f"(float64: gap {kid_gap:.2g} relative), precision {res['precision']:.4f} recall "
          f"{res['recall']:.4f} density {res['density']:.4f} coverage {res['coverage']:.4f} "
          f"(float64 gaps {gaps}); on overlapping manifolds ({len(a)} real against {len(b)} "
          f"of real and fake) " + ", ".join(f"{k} {overlap[k]:.4f}" for k in sorted(overlap))
          + f" (float64 gaps {overlap_gaps}); KID {seen['kid_s']:.3f} s, PRDC {seen['prdc_s']:.3f} s over "
          f"{len(real)} real / {len(fake)} fake; s2d stem features vs plain: {rel:.2g} (f32), "
          f"{rel16:.2g} (bf16) of the largest; stem conv at batch 64, bf16: {stem_ms * 1e3:.1f} us, "
          f"s2d form {s2d_ms * 1e3:.1f} us   [{card}]")
    print("extra_metrics_numbers " + json.dumps(out))
    return launches


def phase_panel(tmp: str, card: str) -> int:
    """``python -m jckx_torch panel`` over seeds 0 and 1, DCGAN at full
    width with KID / PRDC and the s2d stem. → the children's kernel
    launches, as each child trainer logged them."""
    root = os.path.join(tmp, "panel_save")
    argv = ["panel", "--seeds", "0,1", "-m", "DCGAN", "--dataset", "synthetic", "-e", "1",
            "--extra_metrics", "1", "--eval_fast_stem", "1", "-mlr", str(TRAIN_LR),
            "--log_every", "8", "--eval_every", "16", "--save_root", root,
            "--data_dir", os.path.join(tmp, "data"), "--panel_name", "smoke"]
    t0 = time.perf_counter()
    out = _cli(argv, timeout=900)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"panel exited {out.returncode}: {out.stderr[-3000:]}")
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    per = verdict["per_seed"]
    check(verdict["ok"] and verdict["seeds"] == [0, 1] and set(per) == {"0", "1"}
          and all(r["evals"] == 3 and "best_kid" in r and "best_precision" in r
                  for r in per.values())
          and {"best_kid", "best_precision", "best_fid"} <= set(verdict["aggregate"]),
          f"panel verdict {verdict}")
    launches = [int(n) for n in re.findall(r"fused BN kernel launches in this process: (\d+)",
                                           out.stderr)]
    check(launches == [4 * 3, 4 * 3], f"the panel's trainers logged {launches} kernel launches, "
                                      f"want 12 each (4 per eval)")
    agg = verdict["aggregate"]
    print(f"panel of seeds 0, 1 (DCGAN, 64², width 64, bs{TRAIN_BATCH}, 32 steps, 3 evals each, "
          f"KID / PRDC, s2d stem) through python -m jckx_torch panel: {wall:.1f} s, "
          f"{wall / 2:.1f} s per seed (process start, data, backbone and real features included); "
          f"kernel launches {launches}; " + ", ".join(
              f"{k} {agg[k]['min']:.4g}..{agg[k]['max']:.4g}" for k in sorted(agg))
          + f"   [{card}]")
    print("panel_numbers " + json.dumps({"card": card, "wall_s": wall, "per_seed_s": wall / 2,
                                         "launches": launches, "verdict": verdict}))
    return sum(launches)


def _bn_relu_grads(fn, x, scale, bias, dout):
    """``fn``'s (out, mean, var) and the gradients of sum(out · dout)."""
    x = x.detach().requires_grad_(True)
    scale, bias = scale.detach().requires_grad_(True), bias.detach().requires_grad_(True)
    out, mean, var = fn(x, scale, bias)
    (out.float() * dout).sum().backward()
    return out.detach(), mean, var, x.grad, scale.grad, bias.grad


def phase_bn_relu_train(dev, card: str) -> dict:
    """``ops/norm.bn_relu_train`` (the kernel's forward, the hand-written
    backward) against ``bn_relu_train_plain`` (autograd through plain ops),
    both on the card, bf16, at the fine-tune's largest stem maps and one
    Mixed_7c map (bs128, 299²): ``out`` bit-identical to the plain route
    rounded once; against the plain route as jckx rounds it (whose ReLU
    mask the backward recomputes) the statistics within 1e-5 relative, dx
    within one bf16 ulp plus 1e-3 of its largest magnitude (both round an
    f32 dx to bf16; their f32 sums differ in order), dgamma / dbeta within
    1e-3 of their largest magnitude (sums of up to 2.8 M products in
    another order).
    Then the kernel alone at the largest map, timed against its bound.
    → the numbers."""
    import torch
    import torch.nn.functional as F

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.ops.norm import bn_relu_train, bn_relu_train_plain

    g = torch.Generator(device=dev).manual_seed(3)
    worst = {}
    for c, side in FT_BN_SHAPES:
        x = (torch.randn(FT_BATCH, c, side, side, generator=g, device=dev) * 2 + 0.5).to(
            torch.bfloat16, memory_format=torch.channels_last)
        scale = torch.rand(c, generator=g, device=dev) + 0.5
        bias = torch.randn(c, generator=g, device=dev)
        dout = torch.randn(FT_BATCH, c, side, side, generator=g, device=dev).contiguous(
            memory_format=torch.channels_last)
        before = fba.LAUNCHES
        got = _bn_relu_grads(bn_relu_train, x, scale, bias, dout)
        torch.cuda.synchronize()
        check(fba.LAUNCHES == before + 1, "bn_relu_train did not launch the kernel once")
        with torch.no_grad():
            once = bn_relu_train_plain(x, scale, bias, one_rounding=True)[0]
        check(torch.equal(got[0], once),
              f"bn_relu_train's out at {FT_BATCH}x{c}x{side}x{side} differs from the once-rounded "
              f"plain route")
        check(got[0].is_contiguous(memory_format=torch.channels_last), "out not channels_last")
        # the backward recomputes the ReLU mask as x·a + sh > 0 rounded twice, as
        # jckx's does: the twice-rounded plain route has the same mask
        plain = _bn_relu_grads(bn_relu_train_plain, x, scale, bias, dout)
        gaps = {}
        for name, a, b in zip(("mean", "var", "dx", "dgamma", "dbeta"), got[1:], plain[1:]):
            a, b = a.float(), b.float()
            gaps[name] = ((a - b).abs().max() / b.abs().max()).item()
        check(gaps["mean"] <= 1e-5 and gaps["var"] <= 1e-5, f"statistics {gaps}")
        dx, ref = got[3].float(), plain[3].float()
        m = torch.maximum(dx.abs(), ref.abs())
        ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7), torch.zeros_like(m))
        check(bool(((dx - ref).abs() <= ulp + 1e-3 * ref.abs().max()).all()), f"dx {gaps}")
        check(gaps["dgamma"] <= 1e-3 and gaps["dbeta"] <= 1e-3, f"dgamma / dbeta {gaps}")
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, 0.0), v)
        print(f"bn_relu_train at {FT_BATCH}x{c}x{side}x{side} bf16 on the card: 1 launch; out "
              f"bit-identical to the once-rounded plain route; relative gaps to the plain route "
              + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
        del x, dout, got, once, plain

    c, side = FT_BN_SHAPES[0]
    rows = FT_BATCH * side * side
    nbytes = rows * c * 2
    xs = rotation(lambda: (torch.randn(rows, c, generator=g, device=dev)).to(torch.bfloat16),
                  nbytes, cap=4)
    inv = torch.rand(c, generator=g, device=dev) + 0.5
    shift = torch.randn(c, generator=g, device=dev)
    scale = torch.rand(c, generator=g, device=dev) + 0.5
    bias = torch.randn(c, generator=g, device=dev)
    ms = device_ms(lambda x: fba.normalize_act(x, inv, shift, "relu"), [(x,) for x in xs])
    plain = device_ms(lambda x: fba.normalize_act_plain(x, inv, shift, "relu"), [(x,) for x in xs])
    nchw = [(fba._unrows(x, torch.empty(FT_BATCH, c, side, side, device="meta")),) for x in xs]
    lib = device_ms(lambda x: F.relu_(F.batch_norm(x, None, None, scale, bias, training=True,
                                                    eps=1e-3)), nchw)
    lib2 = device_ms(lambda x: _addcmul_relu(x, inv, shift), [(x,) for x in xs])
    bound = max((2 * nbytes + 2 * c * 4) / HBM_BYTES_PER_S, 3 * rows * c / F32_FLOPS_PER_S) * 1e3
    print(f"kernel at the largest fine-tune map ({rows} rows x {c}, bf16): {ms * 1e3:.2f} us, bound "
          f"{bound * 1e3:.2f} us (bytes; {100 * bound / ms:.1f} %), plain {plain * 1e3:.2f} us, "
          f"F.batch_norm + relu {lib * 1e3:.2f} us, the same function in two library calls "
          f"(addcmul, relu_) {lib2 * 1e3:.2f} us   [{card}]")
    out = {"card": card, "rows": rows, "C": c, "ms": ms, "bound_ms": bound, "plain_ms": plain,
           "library_ms": lib, "addcmul_relu_ms": lib2, "max_gaps": worst}
    print("bn_relu_train_numbers " + json.dumps(out))
    return out


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
    CPU's own against weights perturbed by 1e-7 relative. Before the step:
    the branch pool's gradient on a channels_last tensor, the port's and
    ``F.avg_pool2d``'s, against the CPU's."""
    import numpy as np
    import torch

    import torch.nn.functional as F

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.metrics import inception_v3 as tiv
    from jckx_torch.metrics.inception_train import draw_step, make_optimizer, make_train_step

    # the fine-tune's first pool input at bs128 (Mixed_5b, 192 channels at 35²), f32
    g = torch.Generator().manual_seed(13)
    x = torch.randn(FT_BATCH, 192, 35, 35, generator=g)
    dy = torch.randn(FT_BATCH, 192, 35, 35, generator=g)
    pool_grads = {}
    for name, pool in (("port", tiv._avg_pool),
                       ("F.avg_pool2d", lambda t: F.avg_pool2d(t, 3, 1, 1, count_include_pad=True))):
        for device in ("cpu", dev):
            t = x.to(device).contiguous(memory_format=torch.channels_last).requires_grad_(True)
            pool(t).backward(dy.to(device))
            pool_grads[name, str(device)] = t.grad.cpu()
    pool_err = {name: float((pool_grads[name, str(dev)] - pool_grads[name, "cpu"]).norm()
                            / pool_grads[name, "cpu"].norm()) for name in ("port", "F.avg_pool2d")}
    print(f"branch pool gradient on a channels_last {FT_BATCH}x192x35x35 f32 tensor, card vs CPU: "
          f"the port's {pool_err['port']:.3g} relative, F.avg_pool2d's {pool_err['F.avg_pool2d']:.3g} "
          f"(torch {torch.__version__})")
    check(pool_err["port"] <= 1e-6, f"the port's branch pool gradient on the card: {pool_err}")

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
        before = fba.LAUNCHES
        t0 = time.perf_counter()
        loss, acc = step(data.to(device), labels.to(device), idx.to(device),
                         type(draws)(type(draws.crops)(*(t.to(device) for t in draws.crops)),
                                     draws.keep.to(device)))
        loss = float(loss)
        dt = time.perf_counter() - t0
        want = FT_CONVS if device.type == "cuda" else 0
        check(fba.LAUNCHES == before + want,
              f"the fine-tune step on {device} launched {fba.LAUNCHES - before}, want {want}")
        out.append((loss, float(acc), before_flat, tiv.to_jckx_flat(net), dt))
    (lc, ac, b0, pc, tc), (_, _, b1, pp, _), (lg, ag, _, pg, tg) = out
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
          f"statistics {stat_gap:.3g} (<= 1e-3); "
          f"{FT_CONVS} kernel launches on the card; {tc:.2f} s on the CPU, {tg:.2f} s on the card")


def phase_finetune(ctr, tmp: str, card: str) -> int:
    """``python -m jckx_torch finetune`` in this process through its
    ``train()`` at the notebook's geometry (299², bs128, bf16), 2 epochs of
    8 steps on 2560 synthetic rows, eval on 512: exactly 94 launches per
    step and none from the evals; finite losses; the ``.npz`` files and
    ``summary.json``; ``--resume 1`` starts at epoch 2 and trains nothing;
    ``loss_bset.npz`` as ``--metric_backbone`` of ``evaluate`` on the CGAN
    run's ``latest.ckpt``. Then img/s, the step's device ms, busy share, top
    kernels and FLOP share, eval and write seconds, beside the card's name
    and power limit. → kernel launches (the run's and the evaluate's)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from jckx_torch import evaluate
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.metrics.inception_train import draw_step, get_args, train

    save = os.path.join(tmp, "finetune")
    argv = ["--dataset", "synthetic", "--synthetic_size", "2560", "-b", str(FT_BATCH), "-e", "2",
            "--max_steps_per_epoch", "8", "--image_size", str(FT_SIZE), "--eval_samples", "512",
            "--save_dir", save, "--data_dir", os.path.join(tmp, "data")]
    torch.cuda.reset_peak_memory_stats()
    fba.LAUNCHES = 0
    t0 = time.perf_counter()
    run = train(get_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fba.LAUNCHES
    MainLogger.reset()
    steps = sum(e["steps"] for e in run.epochs)
    check(steps == 16 and [e["epoch"] for e in run.epochs] == [0, 1],
          f"fine-tune ran epochs {[e['epoch'] for e in run.epochs]}, {steps} steps")
    check(launches == FT_CONVS * steps,
          f"{launches} kernel launches over {steps} fine-tune steps and 2 evals; want "
          f"{FT_CONVS} per step and none from the evals")
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
          f"bs{FT_BATCH}, {FT_SIZE}², bf16 in {wall:.1f} s (data, init, evals and writes "
          f"included); {launches} kernel launches = {FT_CONVS} x {steps} steps, 0 from the evals; "
          + "; ".join(f"epoch {e['epoch']}: train loss {e['train_loss']:.4f}, valid top1 "
                      f"{e['top1']:.4f} loss {e['loss']:.4f}, eval {e['eval_s']:.3f} s, "
                      f"{len(e['written'])} files written in {e['write_s']:.3f} s"
                      for e in run.epochs) + f"   [{card}]")

    before = fba.LAUNCHES
    again = train(get_args(argv + ["--resume", "1"]))
    MainLogger.reset()
    check(again.start_epoch == 2 and again.epochs == [] and fba.LAUNCHES == before,
          f"--resume 1 started at epoch {again.start_epoch} and ran {again.epochs}")
    print("fine-tune --resume 1 on the same save dir: restored epoch 2, nothing left to train")

    fba.LAUNCHES = 0
    t0 = time.perf_counter()
    res = evaluate.main(["--ckpt", os.path.join(ctr.save_path, "latest.ckpt"), "--dataset",
                         "synthetic", "--metric_backbone", os.path.join(save, "loss_bset.npz")]
                        + _run_dir_args(tmp, "CGAN")[:4])
    ev_launches = fba.LAUNCHES
    MainLogger.reset()
    check(math.isfinite(res["fid"]) and math.isfinite(res["is"]) and ev_launches == 8,
          f"evaluate over the fine-tuned backbone: {res}, {ev_launches} launches")
    print(f"evaluate --metric_backbone finetune/loss_bset.npz on the CGAN run's latest.ckpt: "
          f"{time.perf_counter() - t0:.3f} s, {ev_launches} kernel launches; fid "
          f"{res['fid']:.4f} is {res['is']:.4f} intra_fid {res['intra_fid']:.4f}")

    # timing on the trained net, draws from a generator of their own
    dev = run.data.device
    gen = torch.Generator(device=dev).manual_seed(99)
    idx = torch.arange(FT_BATCH, device=dev)

    def one_step():
        return run.step(run.data, run.labels, idx, draw_step(gen, FT_BATCH, dev))

    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rates = [FT_BATCH / w for w in walls[1:]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        one_step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 4
    torch.cuda.synchronize()
    prof = profile_window(lambda: [one_step() for _ in range(4)],
                          f"4 fine-tune steps at bs{FT_BATCH}, {FT_SIZE}², bf16", card)
    card_ms = prof["busy_ms"] / 4 if prof else None
    with FlopCounterMode(display=False) as fc:
        one_step()
    flops = fc.get_total_flops()
    share = flops / (card_ms * 1e-3) / BF16_FLOPS_PER_S if card_ms else None
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"fine-tune img/s at bs{FT_BATCH}, {FT_SIZE}², bf16, host clock: median "
          f"{statistics.median(rates):.1f} over {len(rates)} steps after the first (min "
          f"{min(rates):.1f}, max {max(rates):.1f}); host enqueue {enqueue_ms:.3f} ms per step; "
          f"step on the card " + (f"{card_ms:.3f} ms" if card_ms else "not measured")
          + f" (profiler busy time / 4); {flops / 1e12:.4f} TFLOP per step "
          f"(torch.utils.flop_counter), " + (f"{100 * share:.2f} %" if share else "not measured")
          + f" of the 989 TFLOP/s bf16 peak; peak device memory {peak:.2f} GiB   [{card}]")
    print("finetune_numbers " + json.dumps({
        "card": card, "batch": FT_BATCH, "image_size": FT_SIZE, "dtype": "bfloat16",
        "wall_s": wall, "launches": launches, "steps": steps,
        "img_per_s_host_median": statistics.median(rates), "step_ms_host": walls[1:],
        "enqueue_ms": enqueue_ms, "step_ms_card": card_ms, "flops_per_step": flops,
        "bf16_peak_share": share, "peak_gib": peak, "profile": prof,
        "epochs": [{k: e[k] for k in ("epoch", "train_loss", "top1", "loss", "train_s", "eval_s",
                                      "write_s", "written")} for e in run.epochs],
        "evaluate": res}))
    return launches + ev_launches


SUPERSTEP_STEPS = 8   # phase_superstep: steps held bit for bit
SUPERSTEP_TIMED = 4   # GAN steps timed and profiled per turn (cut from 8 for the script's time)
SUPERSTEP_MODES = [("DCGAN", "DCGAN", ()), ("CGAN", "CGAN", ()),
                   ("FusedProp", "DCGAN", ("--fused_prop", "1")),
                   ("--remat both", "DCGAN", ("--remat", "both")),
                   ("cosine", "DCGAN", ("--lr_schedule", "cosine"))]


def _step_trainer(tmp: str, model: str, flags: tuple, run: str):
    """A trainer at the reference geometry (bs128, bf16, lr 2e-4, EMA
    0.999) over the 4,096 synthetic rows, built as ``train.main.run``
    builds it but with no evals: the phase drives its launches."""
    import torch

    from jckx_torch.configs import get_arg_parse
    from jckx_torch.data.pipeline import CGANDataPreprocessor, DCGANDataPreprocessor
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.models.dcgan import Discriminator, Generator
    from jckx_torch.train.gan_trainer import CGANTrainer, DCGANTrainer
    from jckx_torch.train.state import geometry

    cfg = get_arg_parse(["-m", model, "--dataset", "synthetic", "-b", str(TRAIN_BATCH), "-e", "1",
                         "-mlr", str(TRAIN_LR), "--eval_every", "0", "--ema_decay", "0.999",
                         *flags] + _run_dir_args(tmp, model, run))
    cfg.save_path = os.path.join(cfg.save_root, model.lower(), run)
    geo, gen = geometry(cfg), torch.Generator().manual_seed(cfg.seed)
    MainLogger.reset()
    if model == "CGAN":
        data = CGANDataPreprocessor(cfg)
        cfg.num_classes = data.num_classes
        tr = CGANTrainer(cfg, CGenerator(geo, cfg.num_classes, gen=gen),
                         CDiscriminator(geo, cfg.num_classes, gen=gen), data)
    else:
        tr = DCGANTrainer(cfg, Generator(geo, gen=gen), Discriminator(geo, gen=gen),
                          DCGANDataPreprocessor(cfg))
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


def _turns(run_eager, run_graph, steps: int, what: str, card: str):
    """Eager and graph in turns (eager, graph, graph, eager) on one state:
    one warm launch, then host ms per step over ``steps`` steps ending in a
    synchronise (and the ms until the host had enqueued them), then the
    profiler over ``steps`` more (device busy ms and share, device events
    and the card's idle gaps over 10 us per step). → {"eager": [...],
    "graph": [...]}."""
    import torch

    out = {"eager": [], "graph": []}
    for turn in ("eager", "graph", "graph", "eager"):
        run = run_eager if turn == "eager" else run_graph
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / steps
        prof = profile_window(run, f"{steps} {what} steps, {turn}", card,
                              top_n=10 if not out[turn] else 0)
        check(bool(prof), f"{what}: the profiler saw no device activity in the {turn} steps")
        rec = {"host_ms": host_ms, "enqueue_ms": 1e3 * (t1 - t0) / steps,
               "busy_ms": prof["busy_ms"] / steps,
               "busy_share": prof["busy_ms"] / prof["window_ms"],
               "events": prof["events"] / steps,
               "long_gaps": prof["gaps_over_10us"] / steps,
               "long_gap_ms": prof["gap_ms_over_10us"] / steps}
        out[turn].append(rec)
    for turn, recs in out.items():
        print(f"{what} step, {turn}: " + "; ".join(
            f"host {r['host_ms']:.3f} ms (enqueued in {r['enqueue_ms']:.3f}), card busy "
            f"{r['busy_ms']:.3f} ms ({100 * r['busy_share']:.1f} % of the window), "
            f"{r['events']:.1f} device events, {r['long_gaps']:.1f} idle gaps over 10 us "
            f"({r['long_gap_ms']:.3f} ms)" for r in recs) + f"   [{card}]")
    return out


def _replayed_launches(replay, card: str, tries: int = 3) -> dict:
    """The fused kernel's launches in one ``replay()`` of a graph (a
    superstep's or a graphed program's), as the profiler sees its ``bn_act``
    kernels and as ``LAUNCHES`` counts them.
    The profiler may drop a record (CUPTI lost ~0.5 % of one 16.5 k-event
    window on an H100), never add one: a window that sees more fails, and
    one that sees fewer is taken again, up to ``tries`` windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jckx_torch.kernels import fused_bn_act as fba

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        before = fba.LAUNCHES
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            replay()
            torch.cuda.synchronize()
        added = fba.LAUNCHES - before
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum("bn_act" in e.name for e in device)
        print(f"one replay, window {attempt}: the profiler saw {seen} bn_act kernels among "
              f"{len(device)} device events; the replay added {added} launches   [{card}]")
        check(seen <= added, f"the profiler saw {seen} bn_act kernels in one replay, more than "
                             f"the {added} the replay counted")
        if seen == added:
            return {"seen": seen, "added": added, "windows": attempt}
    fail(f"the profiler saw fewer bn_act kernels than the replay's {added} in {tries} windows")


def phase_superstep(tmp: str, dev, card: str) -> int:
    """The train step as one CUDA graph (``train/superstep.py``) at full
    width, bs128, bf16:

    - for DCGAN, CGAN, FusedProp, ``--remat both`` and cosine, two
      trainers from the same seed step on the same 8 batches: one eagerly,
      one through its superstep (the first step eager, then the capture,
      7 replays under ``set_sync_debug_mode("error")``); telemetry,
      parameters, EMA and Adam's moments and counts bit for bit (cuDNN
      deterministic for the check);
    - the fine-tune at 299²: one eager step and the capture, then a launch
      of K = 8 replays under the same mode, against 9 eager steps from the
      same weights, rows and draws: loss, accuracy, weights and running
      statistics bit for bit; 94 launches counted per step either way;
    - recaptured under the default algorithms, eager and graph in turns on
      one state (DCGAN, CGAN, the fine-tune; 4 steps a turn): host ms per
      step, device busy ms and share, device events and idle gaps per
      step; the capture's seconds and the graph pool's MB; in one fine-tune replay the
      profiler's ``bn_act`` kernels equal the launches the superstep
      counted (``_replayed_launches``).

    → the fine-tune's kernel launches."""
    import numpy as np
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.metrics import inception_v3 as tiv
    from jckx_torch.metrics.inception_train import (draw_step, make_optimizer, make_superstep,
                                                    make_train_step, step_inputs)
    from jckx_torch.train.superstep import CudaGraph

    t_phase = time.perf_counter()
    n = SUPERSTEP_STEPS
    perm = torch.randperm(4096, generator=torch.Generator().manual_seed(5))
    rows = [{"idx": r} for r in perm[:n * TRAIN_BATCH].view(n, TRAIN_BATCH).to(dev).unbind()]
    numbers = {"card": card, "batch": TRAIN_BATCH, "dtype": "bfloat16", "gan": {}, "finetune": {}}
    timed = {}
    for name, model, flags in SUPERSTEP_MODES:
        eager = _step_trainer(tmp, model, flags, "superstep_eager")
        graphed = _step_trainer(tmp, model, flags, "superstep_graph")
        check(graphed.superstep is not None and graphed.superstep.graph_cls is CudaGraph,
              f"{name}: the trainer on the card has no CUDA graph")
        eager.superstep = None
        with _deterministic_cudnn():
            want = eager._launch(rows)
            got = [graphed._launch(rows[:1])]
            with _no_host_sync():
                got.append(graphed._launch(rows[1:]))
            torch.cuda.synchronize()
        ss = graphed.superstep
        check((ss.captures, ss.replays, ss.launches) == (1, n - 1, 0),
              f"{name}: {ss.captures} captures, {ss.replays} replays, {ss.launches} launches")
        check(torch.equal(torch.cat(got), want), f"{name}: replayed telemetry differs from eager")
        a, b = _trainer_tensors(graphed), _trainer_tensors(eager)
        check(a.keys() == b.keys(), f"{name}: the states hold different tensors")
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        check(not differ, f"{name}: replayed steps differ from eager ones in {differ[:5]}")
        values = sum(v.numel() for v in a.values())
        print(f"{name} ({graphed.geo.image_size}², width {graphed.geo.base_width}, "
              f"bs{TRAIN_BATCH}, bf16): {n} steps through the superstep "
              f"(1 eager, then captured, {n - 1} replayed with no host synchronisation) equal "
              f"{n} eager steps bit for bit: telemetry and {values:,} values of G, D, the EMA and "
              f"Adam's moments and counts (cuDNN deterministic)   [{card}]")
        if name in ("DCGAN", "CGAN"):
            timed[name] = graphed
        del eager, graphed, a, b
        gc.collect()
    for name, tr in timed.items():
        ss = tr.superstep
        ss.invalidate()
        tr._launch(rows[:1])  # eager, then captured under the default algorithms
        torch.cuda.synchronize()
        print(f"{name}: capture {ss.capture_s:.3f} s, graph pool {ss.pool_bytes / 1e6:.1f} MB"
              f"   [{card}]")

        def as_eager(tr, ss, batches):
            tr.superstep = None
            try:
                return tr._launch(batches)
            finally:
                tr.superstep = ss

        k = SUPERSTEP_TIMED
        res = _turns(lambda tr=tr, ss=ss: as_eager(tr, ss, rows[:k]),
                     lambda tr=tr: tr._launch(rows[:k]), k,
                     f"{name} train (bs{TRAIN_BATCH}, bf16)", card)
        numbers["gan"][name] = {"capture_s": ss.capture_s, "pool_mb": ss.pool_bytes / 1e6, **res}
    del timed, tr, ss
    gc.collect()
    torch.cuda.empty_cache()

    # the fine-tune: 9 eager steps against 1 eager + a launch of K = 8 replays
    g = torch.Generator().manual_seed(21)
    data = torch.randint(0, 256, (2560, 32, 32, 3), generator=g, dtype=torch.uint8).to(dev)
    labels = torch.randint(0, 100, (2560,), generator=g).to(dev)
    order = torch.randperm(2560, generator=g)[:9 * FT_BATCH].view(9, FT_BATCH).to(dev)

    def fresh():
        net = tiv.init(0, num_classes=100).to(dev)
        return net, make_train_step(net, make_optimizer(net, 0.1), torch.bfloat16, FT_SIZE)

    def feed(gen, first):
        return lambda j: step_inputs(order[(first + j) % 9], draw_step(gen, FT_BATCH, dev))

    launches = 0
    with _deterministic_cudnn():
        net_e, step_e = fresh()
        gen = torch.Generator(device=dev).manual_seed(7)
        before = fba.LAUNCHES
        want = torch.stack([torch.stack(step_e(data, labels, order[i],
                                               draw_step(gen, FT_BATCH, dev))) for i in range(9)])
        torch.cuda.synchronize()
        eager_launches = fba.LAUNCHES - before
        want_w = tiv.to_jckx_flat(net_e)
        del net_e, step_e
        gc.collect()
        net, step = fresh()
        ss = make_superstep(step, data, labels, CudaGraph)
        gen = torch.Generator(device=dev).manual_seed(7)
        before = fba.LAUNCHES
        got = [ss.replay(1, feed(gen, 0))]
        with _no_host_sync():
            got.append(ss.replay(8, feed(gen, 1)))
        torch.cuda.synchronize()
        graph_launches = fba.LAUNCHES - before
    launches += eager_launches + graph_launches
    check(eager_launches == graph_launches == 9 * FT_CONVS and ss.launches == FT_CONVS,
          f"fine-tune launches: eager {eager_launches}, through the superstep {graph_launches} "
          f"({ss.launches} a replay); want {9 * FT_CONVS}")
    check(torch.equal(torch.cat(got), want), "fine-tune: replayed loss / accuracy differ from eager")
    got_w = tiv.to_jckx_flat(net)
    differ = [k for k in want_w if not np.array_equal(want_w[k], got_w[k])]
    check(not differ, f"fine-tune: the K = 8 launch differs from its eager run in {differ[:5]}")
    print(f"fine-tune ({FT_SIZE}², bs{FT_BATCH}, bf16): 1 eager step + a launch of K = 8 replays "
          f"(no host synchronisation) equal 9 eager steps bit for bit: loss, accuracy and "
          f"{sum(v.size for v in got_w.values()):,} weights and running statistics; "
          f"{FT_CONVS} kernel launches per step either way (cuDNN deterministic)   [{card}]")

    ss.invalidate()
    gen = torch.Generator(device=dev).manual_seed(8)
    before = fba.LAUNCHES
    ss.replay(1, feed(gen, 0))  # eager, then captured under the default algorithms
    torch.cuda.synchronize()
    print(f"fine-tune: capture {ss.capture_s:.3f} s, graph pool {ss.pool_bytes / 1e6:.1f} MB"
          f"   [{card}]")
    k = 4
    res = _turns(lambda: [step(data, labels, order[i], draw_step(gen, FT_BATCH, dev))
                          for i in range(k)],
                 lambda: ss.replay(k, feed(gen, 0)), k,
                 f"fine-tune ({FT_SIZE}², bs{FT_BATCH}, bf16)", card)
    counted = _replayed_launches(lambda: ss.replay(1, feed(gen, 0)), card)
    check(counted["added"] == FT_CONVS, f"one fine-tune replay counted {counted['added']} launches")
    launches += fba.LAUNCHES - before
    numbers["finetune"] = {"capture_s": ss.capture_s, "pool_mb": ss.pool_bytes / 1e6,
                           "bn_act_in_one_replay": counted, **res}
    numbers["phase_s"] = time.perf_counter() - t_phase
    print("superstep_numbers " + json.dumps(numbers))
    del ss, step, net
    gc.collect()
    torch.cuda.empty_cache()
    return launches


INFER_REQUEST = 8 * BATCH   # phase_inference_graph: a request of 4096 (the served-img/s protocol's)
FEATURE_TIMED = 10_000      # fakes whose InceptionV3 features are timed, eager against graph


@contextlib.contextmanager
def _renders_without_sync():
    """Each batch's render inside ``sample()`` (not its drain, which copies
    to the host) under ``set_sync_debug_mode("error")``."""
    import jckx_torch.export as texport
    import jckx_torch.serve as tserve

    real = tserve.pipelined_sample

    def guarded(n, bs, render):
        def render_no_sync(made):
            with _no_host_sync():
                return render(made)

        return real(n, bs, render_no_sync)

    tserve.pipelined_sample = texport.pipelined_sample = guarded
    try:
        yield
    finally:
        tserve.pipelined_sample = texport.pipelined_sample = real


def _serve_turns(obj, what: str, card: str) -> dict:
    """A service or artifact captured again under the default algorithms,
    then eager and graph in turns (eager, graph, graph, eager): per turn a
    warm request, 5 requests of 4096 (median img/s and host ms per batch on
    the host clock) and one profiled request (busy share, device events per
    request and per batch, idle gaps over 10 us, the copies' share of the
    device time). → {"eager": [...], "graph": [...]}."""
    n = INFER_REQUEST
    per = math.ceil(n / obj.batch_size)
    obj.program.invalidate()
    obj.sample(n, seed=0)  # eager first batch, the capture, replays
    out = {"eager": [], "graph": []}
    for turn in ("eager", "graph", "graph", "eager"):
        with eager_route(obj) if turn == "eager" else contextlib.nullcontext():
            obj.sample(n, seed=0)
            walls = []
            for i in range(5):
                t0 = time.perf_counter()
                obj.sample(n, seed=1 + i)
                walls.append(time.perf_counter() - t0)
            prof = profile_window(lambda: obj.sample(n, seed=99),
                                  f"{what}, a request of {n}, {turn}", card,
                                  top_n=0 if out[turn] else 8)
        check(bool(prof), f"{what}: the profiler saw no device activity in the {turn} request")
        wall = statistics.median(walls)
        out[turn].append({
            "img_per_s": n / wall, "host_ms_per_batch": 1e3 * wall / per,
            "busy_share": prof["busy_ms"] / prof["window_ms"],
            "busy_ms_per_batch": prof["busy_ms"] / per,
            "events_per_request": prof["events"], "events_per_batch": prof["events"] / per,
            "gaps_over_10us": prof["gaps_over_10us"], "gap_ms_over_10us": prof["gap_ms_over_10us"],
            "copy_share": prof["by_kind"].get("copy / cast", 0.0) / sum(prof["by_kind"].values())})
    for turn, recs in out.items():
        print(f"{what} at batch {obj.batch_size}, {turn}: " + "; ".join(
            f"{r['img_per_s']:.1f} img/s, host {r['host_ms_per_batch']:.3f} ms per batch, card "
            f"busy {100 * r['busy_share']:.1f} % ({r['busy_ms_per_batch']:.3f} ms per batch), "
            f"{r['events_per_request']} device events per request ({r['events_per_batch']:.1f} "
            f"per batch), {r['gaps_over_10us']} idle gaps over 10 us ({r['gap_ms_over_10us']:.3f} "
            f"ms), copies {100 * r['copy_share']:.1f} % of the device time" for r in recs)
            + f"   [{card}]")
    return out


def phase_inference_graph(tmp: str, dev, card: str, tr, ctr) -> int:
    """jckx's jitted inference programs as CUDA graphs
    (``utils/graphs.GraphedProgram``) at the reference geometry, serving at
    bs512 bf16, ``.pt2`` artifacts at jckx's batch of 64:

    - bit identity, graph against the eager route of the same object (its
      program set to None) from the same seed, cuDNN deterministic: a
      request of 4096 through the float, sub-pixel, int8, truncated (0.7)
      and CGAN samplers (``--labels`` and random classes) and a DCGAN and a
      CGAN ``.pt2``, one replay per batch after the capture, with every
      render (not the drains) under ``set_sync_debug_mode("error")``; an
      HTTP ``/generate`` of 4096 against ``sample()``; the two trainers'
      eval renders (``tr``: DCGAN, ``ctr``: CGAN); ``evaluate`` on the CGAN
      run's ``latest.ckpt``: its renders, features and FID / IS /
      intra-FID; the real features of 10,000 fakes (the metrics engine's
      device path);
    - the fused kernel's launches counted per replay against the
      profiler's ``bn_act`` kernels in one replay (float and int8);
    - under the default algorithms, eager and graph in turns: the float
      and int8 samplers and a ``.pt2`` at batch 512 (``_serve_turns``), and
      ``extract_features`` s over 10,000 rows; capture s and pool MB of
      every graph.

    → the kernel launches of the phase."""
    import numpy as np
    import torch

    from jckx_torch import evaluate as tevaluate
    from jckx_torch.export import ArtifactService, export_generator
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.metrics import metrics as tmetrics
    from jckx_torch.serve import GeneratorService
    from jckx_torch.utils.graphs import CudaGraph

    t_phase = time.perf_counter()
    start = fba.LAUNCHES
    path, cpath = (os.path.join(tmp, f"graph_{m}.pt") for m in ("dcgan", "cgan"))
    write_reference_checkpoint(path)
    write_reference_checkpoint(cpath, conditional=True)
    numbers = {"card": card, "batch": BATCH, "request": INFER_REQUEST, "turns": {}, "graphs": {}}

    def graph_numbers(name, prog):
        """Its last capture's seconds and its graphs' pool, as they stand."""
        numbers["graphs"][name] = {"capture_s": prog.capture_s, "pool_mb": prog.pool_bytes / 1e6,
                                   "keys": len(prog.keys)}

    with _deterministic_cudnn():
        svc, csvc = GeneratorService(path), GeneratorService(cpath)
        int8 = GeneratorService(path, quant="int8")
        arts = {}
        for what, src in (("DCGAN", path), ("CGAN", cpath)):
            dst = os.path.join(tmp, f"graph_{what.lower()}.pt2")
            export_generator(src, dst)  # the defaults: cuda, batch 64, bf16
            arts[what] = ArtifactService(dst)
        routes = [("float", svc, None), ("sub-pixel", GeneratorService(path, subpixel=True), None),
                  ("int8", int8, None),
                  ("truncation 0.7", GeneratorService(path, truncation=0.7), None),
                  ("CGAN --labels", csvc, SERVE_LABELS), ("CGAN random classes", csvc, None),
                  ("DCGAN .pt2", arts["DCGAN"], None), ("CGAN .pt2", arts["CGAN"], SERVE_LABELS)]
        for name, obj, labels in routes:
            prog = obj.program
            check(prog is not None and prog.graph_cls is CudaGraph,
                  f"{name}: the service on the card has no CUDA graph")
            if prog.captures == 0:
                obj.sample(obj.batch_size, labels=labels, seed=0)  # eager, then the capture
            replays, batches = prog.replays, math.ceil(INFER_REQUEST / obj.batch_size)
            with _renders_without_sync():
                got = obj.sample(INFER_REQUEST, labels=labels, seed=3)
                with eager_route(obj):
                    want = obj.sample(INFER_REQUEST, labels=labels, seed=3)
            check(prog.captures == 1 and prog.replays - replays == batches,
                  f"{name}: {prog.captures} captures, {prog.replays - replays} replays for "
                  f"{batches} batches")
            check(got.tobytes() == want.tobytes(),
                  f"{name}: a request of {INFER_REQUEST} through the graph differs from the eager "
                  f"route")
            distinct = {got[i:i + obj.batch_size].tobytes()
                        for i in range(0, INFER_REQUEST, obj.batch_size)}
            check(len(distinct) == batches, f"{name}: a request repeats a batch")
            graph_numbers(f"{name} (batch {obj.batch_size})", prog)
            print(f"{name}: a request of {INFER_REQUEST} in {batches} replays (no host "
                  f"synchronisation in a render) equals the eager route byte for byte   [{card}]")
        d = Daemon(svc)
        try:
            with _renders_without_sync():
                code, _, body = d("/generate", {"n": INFER_REQUEST, "seed": 9, "format": "npy"})
        finally:
            d.close()
        with eager_route(svc):
            want = svc.sample(INFER_REQUEST, seed=9)
        check(code == 200 and _npy(body).tobytes() == want.tobytes(),
              "HTTP /generate through the graph differs from the eager route's sample()")
        print(f"HTTP /generate of {INFER_REQUEST} (npy) through the graph equals the eager "
              f"route's sample() byte for byte   [{card}]")

        for model, t in (("DCGAN", tr), ("CGAN", ctr)):
            t.eval_program.invalidate()  # captured again under deterministic cuDNN
            t.sample_eval()
            with _no_host_sync():
                got = t.sample_eval()
            with eager_route(t, "eval_program"):
                want = t.sample_eval()
            prog = t.eval_program
            check(torch.equal(got, want), f"{model} trainer: replayed eval renders differ from eager")
            graph_numbers(f"{model} eval sampler ({min(t.eval_z.shape[0], CGAN_CHUNK)} rows)", prog)
            print(f"{model} trainer: the eval renders of {t.eval_z.shape[0]} rows, replayed "
                  f"({prog.captures} capture, {prog.replays} replays), equal the eager route bit "
                  f"for bit   [{card}]")

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
        graph_numbers("evaluate sampler (500 rows)", seen["program"][0])
        graph_numbers(f"evaluate features (batch {ctr.cfg.eval_batch_size})", seen["engine"][0])
        print(f"evaluate on the CGAN run's latest.ckpt: renders (2 forwards of 500), features and "
              f"{ {k: scored[0][k] for k in ('fid', 'is', 'intra_fid')} } equal the eager route's "
              f"exactly   [{card}]")

        m = tr.metric  # the DCGAN run's engine: batch 256, bf16
        fakes = (torch.rand((FEATURE_TIMED, tr.geo.image_size, tr.geo.image_size, 3), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(6)) * 2 - 1
                 ).to(torch.bfloat16)
        m.program.invalidate()
        got = m.extract_features(fakes)
        with eager_route(m):
            want = m.extract_features(fakes)
        check(np.array_equal(got, want), "the features of 10,000 rows through the graph differ "
                                         "from the eager route")
        real_u8 = tr.data_pre.metric_source[0]  # the host path: slabs of the 32² real set
        got = m._extract_u8(real_u8)  # a second key, in the program's one pool
        with eager_route(m):
            want = m._extract_u8(real_u8)
        check(np.array_equal(got, want) and len(m.program.keys) == 2,
              "the real set's features through the graph differ from the eager route")
        print(f"the InceptionV3 features of {FEATURE_TIMED} fakes at batch {m.batch_size} and of "
              f"the {len(real_u8)} real rows (the slab path, a second graph in the program's "
              f"pool; {m.program.replays} replays) equal the eager route's bit for bit   [{card}]")

    z = torch.randn(BATCH, svc.geo.z_dim, generator=torch.Generator(device=dev).manual_seed(8),
                    device=dev)
    for name, obj in (("float", svc), ("int8", int8)):
        counted = _replayed_launches(lambda obj=obj: obj.render(z), card)
        check(counted["added"] == svc.geo.n_up,
              f"{name}: one replay counted {counted['added']} launches, want {svc.geo.n_up}")
        numbers[f"bn_act_in_one_replay_{name}"] = counted

    art512 = os.path.join(tmp, "graph_dcgan_512.pt2")
    export_generator(path, art512, batch_size=BATCH)
    art512 = ArtifactService(art512)
    for name, obj in (("float", svc), ("int8", int8), (".pt2", art512)):
        numbers["turns"][name] = _serve_turns(obj, f"{name} serving", card)
        graph_numbers(f"{name} (batch {obj.batch_size}, default algorithms)", obj.program)
    m.program.invalidate()
    m.extract_features(fakes[:m.batch_size])  # the capture under the default algorithms
    secs = {"eager": [], "graph": []}
    for turn in ("eager", "graph", "graph", "eager"):
        with eager_route(m) if turn == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            m.extract_features(fakes)
            secs[turn].append(time.perf_counter() - t0)
    graph_numbers(f"InceptionV3 features (batch {m.batch_size}, default algorithms)", m.program)
    numbers["features_s"] = secs
    print(f"extract_features of {FEATURE_TIMED} rows at batch {m.batch_size}, bf16, in turns: "
          f"eager {secs['eager']} s, graph {secs['graph']} s   [{card}]")
    for name, g in numbers["graphs"].items():
        print(f"  graph {name}: last capture {g['capture_s']:.3f} s, pool {g['pool_mb']:.1f} MB "
              f"over {g['keys']} key(s)   [{card}]")
    launches = fba.LAUNCHES - start
    numbers["launches"] = launches
    numbers["phase_s"] = time.perf_counter() - t_phase
    print("inference_graph_numbers " + json.dumps(numbers))
    del svc, csvc, int8, arts, routes, art512, fakes
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_fused_prop_train(tmp: str, card: str) -> int:
    """DCGAN with ``--fused_prop 1`` through the entry point at full width,
    as ``phase_train`` (32 steps, evals after 8, 16, 32: 4 launches each,
    none from the steps); then its step and the faithful step on the same
    state, in turns (faithful, FusedProp, FusedProp, faithful): device ms
    and device events per step (profiler busy time of 4 steps / 4) and the
    host ms, beside the card's name and power limit. → the run's kernel
    launches."""
    import copy

    import torch

    from jckx_torch.data.pipeline import decode_batch
    from jckx_torch.train.steps import make_dcgan_train_step

    tr, steps, _, launches = phase_train(tmp, "DCGAN", ("--fused_prop", "1"), "smoke_fused_prop")
    n = 4  # steps timed and profiled per turn (cut from 8 for the script's time)
    check(tr.cfg.fused_prop == 1, "the trainer did not take --fused_prop 1")
    rates = [r["images_per_sec"] for r in steps[1:]]
    print(f"DCGAN FusedProp train img/s at batch {TRAIN_BATCH}, bf16, host clock: median "
          f"{statistics.median(rates):.1f} over the {len(rates)} launches after the first (min "
          f"{min(rates):.1f}, max {max(rates):.1f})   [{card}]")
    faithful = copy.copy(tr.cfg)
    faithful.fused_prop = 0
    fns = {"faithful": make_dcgan_train_step(faithful, tr.geo), "FusedProp": tr.step_fn}
    real = decode_batch(tr.images_dev[:TRAIN_BATCH], tr.cfg.image_size, tr.cd)
    seen = {name: [] for name in fns}
    for name in ("faithful", "FusedProp", "FusedProp", "faithful"):
        fn = fns[name]
        for _ in range(2):
            fn(tr.state, real)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(tr.state, real)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / n
        prof = profile_window(lambda: [fn(tr.state, real) for _ in range(n)],
                              f"{n} DCGAN {name} steps at batch {TRAIN_BATCH}, bf16", card,
                              top_n=0 if seen[name] else 10)
        check(bool(prof), f"the profiler saw no device activity in the {name} steps")
        seen[name].append((prof["busy_ms"] / n, prof["events"] / n, host_ms))
    for name, runs in seen.items():
        print(f"DCGAN {name} step at batch {TRAIN_BATCH}, bf16: "
              + "; ".join(f"{ms:.3f} ms on the card, {ev:.1f} device events, {h:.3f} ms on the "
                          f"host clock" for ms, ev, h in runs) + f"   [{card}]")
    return launches


def phase_remat(dev, card: str) -> None:
    """One full-width DCGAN step (64², z 100, width 64, batch 128, bf16)
    under each ``--remat`` mode from the same weights and draws: the
    parameters after the step against ``none``'s (Adam deltas within 5 % of
    lr where ``none``'s gradient clears 1 % of its leaf's maximum, on all
    but 0.1 % of those elements; the max |diff| printed), the peak device
    memory of a second step, and the device ms per step (profiler busy time
    of 4 steps / 4), beside the card's name and power limit."""
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
        prof = profile_window(lambda: [step(state, real, draws) for _ in range(4)],
                              f"4 DCGAN steps, --remat {mode}, batch {TRAIN_BATCH}, bf16", card,
                              top_n=0)
        out[mode] = (delta, grads, peak, held, prof["busy_ms"] / 4 if prof else None)
        del state, nets, step
        torch.cuda.empty_cache()
    d_none, g_none = out["none"][0], out["none"][1]
    for mode, (delta, _, peak, held, ms) in out.items():
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
              f"step {peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} GiB above the state); "
              + (f"{ms:.3f} ms per step on the card" if ms is not None else "device ms not measured")
              + f"   [{card}]")


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
        t0 = time.perf_counter()
        try:
            one_step(True, bad)
        except RuntimeError as e:
            msg = str(e)
        dt = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = prev
    found = re.search(r"Function '(\w+)' returned nan values", msg)
    check(found is not None, f"a NaN batch under --sanitize did not raise anomaly mode's error: {msg!r}")
    check(not torch.is_anomaly_enabled(), "anomaly detection left on after the run")
    print(f"--sanitize: a clean full-width step equals the plain one bit for bit; a NaN in the "
          f"real batch raised in {dt:.2f} s naming {found.group(1)}")


def phase_profile_dir(tmp: str, card: str) -> int:
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
    fba.LAUNCHES = 0
    t0 = time.perf_counter()
    tr = tmain.main(argv)
    wall = time.perf_counter() - t0
    launches = fba.LAUNCHES
    MainLogger.reset()
    check(tr.state.step == 4 and tr.evals == [4] and launches == tr.geo.n_up,
          f"--profile_dir run: step {tr.state.step}, evals {tr.evals}, {launches} launches")
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
    print(f"--profile_dir: {wall:.1f} s run of 4 steps + 1 eval wrote {os.path.basename(traces[0])} "
          f"({os.path.getsize(traces[0]) / 2**20:.1f} MiB, {len(events)} events) naming "
          f"{', '.join(has)}, and {len(kernels)} device kernels of its {len(replays)} graph "
          f"launches (3 replayed steps, {want - 3} feature batches); {launches} kernel launches"
          f"   [{card}]")
    return launches


def phase_jckx_ckpt(tmp: str, dev, card: str) -> int:
    """jckx ``.ckpt`` files read without JAX: the committed fixture
    (tests/data/jckx_ckpt, written by jckx's trainer on the CPU). Each file
    served on the card in f32 (``GeneratorService``) and rendered by
    ``evaluate``'s route (``load_generator`` + ``make_sampler`` +
    ``sample_eval_images``) on the fixture's 16 latents: through the kernel
    (2 launches per forward at 16²), within 1 LSB of jckx's own renders,
    99 % exactly equal; ``evaluate`` end to end (finite IS / FID at step
    4); ``convert`` to ``.pt`` and ``inspect`` exit 0;
    and ``train --resume`` of the DCGAN run dir takes one more eval and
    writes the port's ``latest.ckpt`` at step 8. → the kernel launches."""
    import shutil
    import zipfile

    import numpy as np
    import torch

    from jckx_torch import convert as tconvert
    from jckx_torch import evaluate
    from jckx_torch import inspect as tinspect
    from jckx_torch.checkpoint.checkpoint import load_checkpoint, load_generator
    from jckx_torch.data.pipeline import one_hot
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.ops.quant import make_sampler
    from jckx_torch.serve import GeneratorService, tanh_to_u8
    from jckx_torch.train import main as tmain
    from jckx_torch.train.gan_trainer import sample_eval_images

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jckx_ckpt")
    z = torch.from_numpy(np.load(os.path.join(root, "z.npy"))).to(dev)
    labels = torch.from_numpy(np.load(os.path.join(root, "cgan_labels.npy"))).to(dev)
    data = os.path.join(tmp, "data_jckx")
    total = 0
    for family in ("dcgan", "cgan"):
        cgan = family == "cgan"
        path = os.path.join(root, family, "run", "latest.ckpt")
        want = tanh_to_u8(torch.from_numpy(np.load(os.path.join(root, f"{family}_renders.npy"))))
        svc = GeneratorService(path, batch_size=len(z), compute_dtype=torch.float32, device=dev)
        before = fba.LAUNCHES
        served = svc.render(z, labels if cgan else None).cpu()
        lg = load_generator(path)
        params, apply = make_sampler(lg.G.to(dev), compute_dtype=torch.float32)
        onehot = one_hot(labels, lg.num_classes) if cgan else None
        scored = tanh_to_u8(sample_eval_images(
            lambda zz, *rest: apply(params, zz, rest[0] if cgan else None), z, onehot,
            torch.float32)).cpu()
        n = fba.LAUNCHES - before
        check(n == 2 * svc.geo.n_up, f"{family} fixture renders launched the kernel {n} times")
        for what, got in (("serve", served), ("evaluate's sampler", scored)):
            diff = (got.int() - want.int()).abs()
            exact = (diff == 0).float().mean().item()
            check(diff.max().item() <= 1 and exact >= 0.99,
                  f"{family} fixture {what}: {diff.max().item()} LSB, {100 * exact:.4f} % exact")
            print(f"jckx {family} .ckpt (step {svc.step}, EMA {svc.used_ema}) through {what} on "
                  f"the card, f32, batch {len(z)}: max diff {diff.max().item()} LSB from jckx's "
                  f"renders, {100 * exact:.4f} % exactly equal")
        fba.LAUNCHES = 0
        res = evaluate.main(["--ckpt", path, "--dataset", "cifar10" if cgan else "synthetic",
                             "--synthetic_size", "512", "--data_dir", data, "--save_root",
                             os.path.join(tmp, "save"), "--compute_dtype", "float32"])
        MainLogger.reset()
        total += n + fba.LAUNCHES
        check(res["step"] == 4 and math.isfinite(res["fid"]) and math.isfinite(res["is"])
              and fba.LAUNCHES == svc.geo.n_up, f"evaluate {family} fixture: {res}, "
              f"{fba.LAUNCHES} launches")
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
    fba.LAUNCHES = 0
    tr = tmain.main(["--resume", "-pm", "run", "-e", "2", "--save_root", save, "--data_dir", data])
    MainLogger.reset()
    latest = os.path.join(save, "dcgan", "run", "latest.ckpt")
    check(tr.device.type == "cuda" and tr.state.step == 8 and tr.evals == [8]
          and fba.LAUNCHES == tr.geo.n_up and zipfile.is_zipfile(latest)
          and load_checkpoint(latest)["step"] == 8,
          f"--resume of jckx's run dir: step {tr.state.step}, evals {tr.evals}, "
          f"{fba.LAUNCHES} launches")
    print(f"train --resume of jckx's DCGAN run dir (step 4, {tr.cfg.compute_dtype}): one more eval "
          f"at step 8 ({fba.LAUNCHES} launches), the port's latest.ckpt written at step 8   [{card}]")
    return total + fba.LAUNCHES



def trace_copies(prof, tmp: str) -> tuple:
    """→ (host→device copies, device kernels, the window in µs) of a
    profile; copies are (stream, start µs, duration µs, bytes or None),
    kernels the same and their name, read from its Chrome trace
    (``FunctionEvent`` carries no stream)."""
    path = os.path.join(tmp, "planes_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    copies, kernels = [], []
    timed = [e for e in events if "ts" in e and "dur" in e]
    window = (max(float(e["ts"]) + float(e["dur"]) for e in timed)
              - min(float(e["ts"]) for e in timed))
    for e in timed:
        args = e.get("args") or {}
        if "stream" not in args:
            continue
        rec = (args["stream"], float(e["ts"]), float(e["dur"]), args.get("bytes"))
        if e.get("cat") == "kernel":
            kernels.append(rec + (e.get("name", "")[:80],))
        elif "memcpy" in e.get("cat", "").lower() and "HtoD" in e.get("name", ""):
            copies.append(rec)
    return copies, kernels, window


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


def _plane_trainer(cfg, data_pre, metrics, conditional: bool = False):
    """The trainer ``jckx_torch.train.main.run`` builds, on ``data_pre``."""
    import torch

    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.models.dcgan import Discriminator, Generator
    from jckx_torch.train.gan_trainer import CGANTrainer, DCGANTrainer
    from jckx_torch.train.state import geometry

    geo = geometry(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    if conditional:
        return CGANTrainer(cfg, CGenerator(geo, data_pre.num_classes, gen=gen),
                           CDiscriminator(geo, data_pre.num_classes, gen=gen), data_pre,
                           metrics=metrics)
    return DCGANTrainer(cfg, Generator(geo, gen=gen), Discriminator(geo, gen=gen), data_pre,
                        metrics=metrics)


def phase_data_planes(tmp: str, dev, card: str) -> int:
    """The data planes on the card (``data/native_io.py``, ``datasets.py``,
    ``pipeline.py``): the native library loads; a planted CIFAR-100 pickle
    of 50,000 rows is parsed and cached, then mapped; real features of
    10,000 mapped rows through the metrics engine's slab path (8 MB slabs:
    4 of them) equal the per-batch path's; DCGAN trains 32 steps (K = 8,
    evals after 8 and 32) on 4,096 mapped rows, resident and streamed
    (``-w 4``) in turns from the same weights with deterministic
    algorithms, to the same parameters bit for bit, and once more streamed
    with its third launch profiled (busy share, the slab's host→device
    copy, its stream, its overlap with kernels); CGAN
    streams the whole set under ``auto`` with a 100 MB budget, is cut by
    SIGTERM after its first launch of 8 steps and evaluated once; and the
    folder plane trains 4 steps where PIL imports, else refuses naming PIL.
    → the kernel launches of its evals."""
    import pickle
    import signal
    import threading

    import numpy as np
    import torch

    from jckx_torch.configs import get_arg_parse
    from jckx_torch.data import datasets, native_io
    from jckx_torch.data.pipeline import CGANDataPreprocessor, DCGANDataPreprocessor
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.artifacts import encode_png
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.metrics import inception_v3
    from jckx_torch.metrics.metrics import Metrics
    from jckx_torch.train import main as tmain

    t0 = time.perf_counter()
    check(native_io.available(), f"the native I/O library did not load: "
                                 f"{native_io.fallback_reason()}")
    print(f"native I/O library {os.path.basename(native_io.library_path())} built with g++ and "
          f"loaded in {time.perf_counter() - t0:.2f} s")

    data_dir = os.path.join(tmp, "planes_data")
    os.makedirs(os.path.join(data_dir, "cifar-100-python"))
    rng = np.random.default_rng(0)
    pix = rng.integers(0, 256, (DATA_ROWS, 3072), dtype=np.uint8)
    fine = rng.integers(0, 100, DATA_ROWS)
    with open(os.path.join(data_dir, "cifar-100-python", "train"), "wb") as f:
        pickle.dump({b"data": pix, b"fine_labels": fine.tolist()}, f, protocol=4)
    t0 = time.perf_counter()
    x1, y1, ncls, _, synthetic = datasets.load_dataset("cifar100", data_dir)
    parse_s = time.perf_counter() - t0
    cache = os.path.join(data_dir, "jckx_cache_cifar100_train.bin")
    check(os.path.getsize(cache) == 32 + DATA_ROWS * (3072 + 4) and not synthetic,
          f"cache {os.path.getsize(cache)} bytes")
    t0 = time.perf_counter()
    x, y, _, _, _ = datasets.load_dataset("cifar100", data_dir)
    map_s = time.perf_counter() - t0
    check(np.array_equal(x, x1) and np.array_equal(y, y1) and not x.flags.writeable
          and np.array_equal(x, pix.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)),
          "the mapped cache differs from the parsed archive")
    print(f"CIFAR-100 pickle of {DATA_ROWS} rows: parse + cache write {parse_s:.3f} s, then the "
          f"cache ({os.path.getsize(cache)} bytes) mapped in {map_s:.4f} s; arrays equal   [{card}]")
    del x1, y1, pix

    # the metrics engine's slab path against its per-batch path, and the two
    # DCGAN planes, with deterministic algorithms (without filling fresh
    # memory: that would put fill kernels on the copy stream)
    real = x[:FEATURE_ROWS]
    cd = torch.bfloat16
    deterministic = torch.backends.cudnn.deterministic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    saved_slab, Metrics._SLAB_BYTES = Metrics._SLAB_BYTES, FEATURE_SLAB_BYTES
    try:
        t0 = time.perf_counter()
        eng = Metrics((real, y[:FEATURE_ROWS]), backbone=inception_v3.init(0, num_classes=ncls),
                      batch_size=256, compute_dtype=cd, cache_dir=os.path.join(tmp, "planes_feat"),
                      num_classes=ncls, device=dev)
        first_s = time.perf_counter() - t0
        to01 = lambda u8: u8.to(cd) / 255.0  # noqa: E731
        times = {"per-batch": [], "slab": []}
        for path in ("per-batch", "slab"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = (_per_batch_features(eng, real, to01) if path == "per-batch"
                 else eng._extract_u8(real))
            times[path].append(time.perf_counter() - t0)
            check(np.array_equal(f, eng.real_features), f"{path} features differ from the engine's")
    finally:
        Metrics._SLAB_BYTES = saved_slab
    bs = min(256, FEATURE_ROWS)
    n_slabs = math.ceil(math.ceil(FEATURE_ROWS / bs) / max(1, FEATURE_SLAB_BYTES // (3072 * bs)))
    check(n_slabs >= 2, f"{FEATURE_ROWS} rows fit one slab: the overlap is not exercised")
    print(f"real features of {FEATURE_ROWS} mapped rows, bs256, bf16, deterministic: slab "
          f"path ({n_slabs} slabs of <= {FEATURE_SLAB_BYTES >> 20} MB, pinned, copied on a side "
          f"stream) "
          + ", ".join(f"{t:.3f}" for t in times["slab"]) + " s, per-batch path "
          + ", ".join(f"{t:.3f}" for t in times["per-batch"]) + f" s (engine's first extraction, "
          f"backbone init included, {first_s:.3f} s); features equal   [{card}]")

    launches = 0
    fba.LAUNCHES = 0
    try:
        # DCGAN from the same weights: the planes timed in turns, then one more
        # streamed run with its third launch profiled (the profiler slows the host)
        finals, rates, step_ms, prof_out = [], {"hbm": [], "stream": []}, {"hbm": [], "stream": []}, {}
        for i, (placement, profiled) in enumerate((("hbm", False), ("stream", False),
                                                   ("stream", False), ("hbm", False),
                                                   ("stream", True))):
            argv = ["--dataset", "cifar100", "--data_dir", data_dir, "-b", str(TRAIN_BATCH),
                    "-e", "1", "-mlr", str(TRAIN_LR), "--log_every", "8", "--eval_every", "32",
                    "--data_placement", placement, "-w", "4", "--save_root",
                    os.path.join(tmp, "save"), "-pm", f"smoke_plane_{i}_{placement}"]
            cfg = get_arg_parse(argv)
            cfg.save_path = os.path.join(cfg.save_root, "dcgan", cfg.model_path)
            pre = DCGANDataPreprocessor(cfg)
            pre.images_u8, pre.labels_np = pre.images_u8[:PLANE_ROWS], pre.labels_np[:PLANE_ROWS]
            check(not pre.images_u8.flags.writeable, "the plane's rows are not the mapped cache")
            tr = _plane_trainer(cfg, pre, eng)
            check(tr._streaming is (placement == "stream"), f"{placement}: streaming {tr._streaming}")
            if profiled:
                # from the end of launch 2 to the start of launch 4: launch 3,
                # whose start enqueues slab 4's gather and copy (launches, not
                # steps: a launch's steps after the first are graph replays)
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                calls, real_launch = [0], tr._launch

                def launch(batches, prof=prof, calls=calls, real_launch=real_launch):
                    calls[0] += 1
                    if calls[0] == 4:
                        torch.cuda.synchronize()
                        prof.stop()
                        prof_out["prof"] = prof
                    rows = real_launch(batches)
                    if calls[0] == 2:
                        prof.start()
                    return rows

                tr._launch = launch
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            MainLogger.reset()
            check(tr.state.step == 32 and tr.evals == [8, 32], f"{placement}: step "
                  f"{tr.state.step}, evals {tr.evals}")
            finals.append((placement, {**{f"G.{k}": v for k, v in tr.state.G.state_dict().items()},
                                       **{f"D.{k}": v for k, v in tr.state.D.state_dict().items()}}))
            if profiled:
                continue
            with open(os.path.join(tr.save_path, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f if "step_ms" in line]
            rates[placement] += [r["images_per_sec"] for r in recs[1:]]
            step_ms[placement] += [r["step_ms"] for r in recs[1:]]
            print(f"DCGAN --data_placement {placement}{' -w 4' if placement == 'stream' else ''} "
                  f"(run {i + 1}): 32 steps on {PLANE_ROWS} mapped rows at batch {TRAIN_BATCH}, "
                  f"bf16, evals after {tr.evals}, {wall:.1f} s; img/s on the host clock "
                  + ", ".join(f"{r['images_per_sec']:.1f}" for r in recs[1:])
                  + " over the launches after the first")
        for placement in ("hbm", "stream"):
            print(f"DCGAN {placement} plane, bs{TRAIN_BATCH} bf16: median "
                  f"{statistics.median(rates[placement]):.1f} img/s (min "
                  f"{min(rates[placement]):.1f}, max {max(rates[placement]):.1f}), "
                  f"{statistics.median(step_ms[placement]):.3f} ms per step on the host clock, over "
                  f"{len(rates[placement])} launches of two runs in turns   [{card}]")
        ref = finals[0][1]
        diffs = [(i, k) for i, (_, sd) in enumerate(finals[1:], 2) for k in ref
                 if not torch.equal(ref[k], sd[k])]
        check(diffs == [], f"parameters differ from the first resident run's: {diffs[:5]}")
        print(f"DCGAN: all {len(finals)} runs (resident and streamed) end with bit-identical "
              f"parameters ({sum(v.numel() for v in ref.values())} values incl. BN buffers; "
              f"deterministic algorithms)")
        check("prof" in prof_out, "the streamed launch was not profiled")
        copies, kernels, window = trace_copies(prof_out["prof"], tmp)
        slab_bytes = 8 * TRAIN_BATCH * 32 * 32 * 3
        slab = [c for c in copies if c[3] == slab_bytes]
        check(len(slab) >= 1, f"no host→device copy of a slab ({slab_bytes} bytes) in the "
                              f"profiled launch: {copies}")
        compute = {k[0] for k in kernels}
        copy_streams = {c[0] for c in slab}
        shared = {k[4] for k in kernels if k[0] in copy_streams}
        check(not shared, f"slab copies on stream(s) {copy_streams}, which also ran kernels "
                          f"{sorted(shared)[:5]}")
        spans = sorted((k[1], k[1] + k[2]) for k in kernels)
        check(bool(spans), "the profiler saw no kernel in the streamed launch")
        if spans and slab:
            overlap = [any(ks < cs + cd_ and cs < ks + kd for _, ks, kd, _, _ in kernels)
                       for _, cs, cd_, _ in slab]
            busy, (lo, hi) = 0.0, spans[0]
            for s, e in spans[1:]:  # union of the kernels' intervals
                if s > hi:
                    busy, lo = busy + hi - lo, s
                hi = max(hi, e)
            busy += hi - lo
            print(f"profiled streamed launch: window {window / 1e3:.3f} ms, card busy "
                  f"{busy / 1e3:.3f} ms ({100 * busy / window:.1f} %), {len(kernels)} kernels; "
                  f"slab copy " + ", ".join(f"{d / 1e3:.4f} ms ({b_ / d / 1e3:.2f} GB/s)"
                                            for _, _, d, b_ in slab)
                  + f" of {slab_bytes} bytes on stream {sorted(copy_streams)}, kernels on "
                  f"stream(s) {sorted(compute)}; overlapped compute kernels: {overlap}   [{card}]")

        # CGAN streams the whole mapped set under auto (153.6 MB > 100 MB)
        argv = ["-m", "CGAN", "--dataset", "cifar100", "--data_dir", data_dir, "-b",
                str(TRAIN_BATCH), "-e", "1", "-mlr", str(TRAIN_LR), "--log_every", "8",
                "--data_placement", "auto", "--hbm_data_budget", "100000000", "-w", "4",
                "--save_root", os.path.join(tmp, "save"), "-pm", "smoke_plane_auto"]
        cfg = get_arg_parse(argv)
        cfg.save_path = os.path.join(cfg.save_root, "cgan", cfg.model_path)
        tr = _plane_trainer(cfg, CGANDataPreprocessor(cfg), eng, conditional=True)
        check(tr._streaming and tr.images_dev is None, "auto did not stream 153.6 MB over a "
                                                        "100 MB budget")
        real_launch, calls = tr._launch, [0]

        def cut(batches):
            calls[0] += 1
            if calls[0] == 1:
                os.kill(os.getpid(), signal.SIGTERM)  # preempt_save: latest.ckpt after this launch
            return real_launch(batches)

        tr._launch = cut
        t0 = time.perf_counter()
        tr.train()
        tr._evaluate(tr.state.step, [], [])
        wall = time.perf_counter() - t0
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
              f"in its first launch saved latest.ckpt at step 8 and stopped the uploader; 8 steps "
              f"+ one eval in {wall:.1f} s   [{card}]")

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
    # 4 per G forward: DCGAN 5 runs x 2 evals, CGAN 1 eval of 2 forwards, the folder run's eval
    want = 4 * (5 * 2 + 2 + (1 if folder_trained else 0))
    check(launches == want, f"the data-plane phase launched the kernel {launches} times, want "
                            f"{want}: 4 per G forward of its evals")
    print(f"data-plane phase: {launches} kernel launches (its evals)")
    return launches


# ------------------------------------------------------------------ the mesh

MESH_STEPS = 8                          # phase_mesh: steps of each run (one launch, one eval)
MESH_ROWS = TRAIN_BATCH * MESH_STEPS    # its synthetic rows: one epoch of MESH_STEPS steps
MESH_TIMED = 6                          # bf16 steps timed per turn
MESH_WARM = 2                           # phase_mesh_model: untimed bf16 steps first (8 in all)
# phase_mesh_model's first-step rule: G's f32 gradient at full width is so
# ill-conditioned that nudging the weights by 1e-6 relative moves it 1.9 %
# in L2 and flips 20 masked Adam deltas (10 in each of two leaves), and a
# per-leaf 0.1 % bound allows no flip in a 495-element BN leaf; so the
# flips are counted over each net (0.1 % of its masked deltas), and every
# leaf's gradient must lie within 5 % in L2 of the plain run's (ROADMAP C:
# rounding error up to ~5 % of a leaf's largest gradient at full width)
MODEL_GRAD_GAP = 0.05
MODEL_FLOOR = 1e-6
GAP_THREADS = 2                         # CPU threads of each rank of the first-step control
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
    if spec.get("perturb"):  # the comparison's noise floor: the same run from nudged weights
        make_state = gan_trainer.create_dcgan_state

        def nudged(cfg, G, D, mesh=None):
            with torch.no_grad():
                g = torch.Generator().manual_seed(5)
                for p in list(G.parameters()) + list(D.parameters()):
                    p.mul_(1 + spec["perturb"] * torch.randn(p.shape, generator=g).to(p.device))
            return make_state(cfg, G, D, mesh)

        gan_trainer.create_dcgan_state = nudged
    fba.LAUNCHES = 0
    tr = tmain.run(get_arg_parse(spec["argv"]))
    rank = dist.get_rank() if dist.is_initialized() else 0
    rec = {"launches": fba.LAUNCHES, "step": tr.state.step, "evals": tr.evals}
    last = _snapshot(tr.state)
    if spec.get("renders"):
        rec["renders_equal_once"] = _renders_equal_once(tr)
    if rank == 0:
        rec.update(last, first=first, telemetry=telemetry)
    torch.save(rec, f"{spec['out']}.rank{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()


def _count_collectives(counts: dict):
    """Wrap ``torch.distributed.all_reduce`` / ``all_gather`` to count calls
    by kind (BN statistics (2, C), the flat gradient buffers, the rest) and
    their host seconds. → a function that restores them."""
    import torch.distributed as dist

    real_reduce, real_gather = dist.all_reduce, dist.all_gather

    def timed(fn, kind):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                counts[kind] = counts.get(kind, 0) + 1
                counts["host_s"] = counts.get("host_s", 0.0) + time.perf_counter() - t0
        return wrapper

    def all_reduce(t, *args, **kwargs):
        kind = ("bn_stats" if t.dim() == 2 and t.shape[0] == 2 else
                "grads" if t.dim() == 1 and t.numel() > 1024 else "other")
        return timed(real_reduce, kind)(t, *args, **kwargs)

    dist.all_reduce, dist.all_gather = all_reduce, timed(real_gather, "all_gather")

    def restore():
        dist.all_reduce, dist.all_gather = real_reduce, real_gather

    return restore


def child_time(spec: dict) -> None:
    """bf16 DCGAN steps at full width (global batch 128) on the process
    group: ``nccl`` — a world of one, timed in turns against the same step
    without a mesh (plain, mesh, mesh, plain); ``gloo`` — this rank's share
    of the pair. Host ms per step (each synchronised), the collectives per
    step by kind and their host share, and a profiled window."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from jckx_torch.configs import Config
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.parallel import make_mesh
    from jckx_torch.train.state import create_dcgan_state
    from jckx_torch.train.steps import make_dcgan_train_step

    dev = _child_init(spec["backend"])
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    mesh = make_mesh((dist.get_world_size(),), device=dev)
    cfg, geo = Config(), GANGeometry()
    cfg.compute_dtype, cfg.max_learning_rate = "bfloat16", TRAIN_LR
    gen = torch.Generator().manual_seed(0)
    state = create_dcgan_state(cfg, Generator(geo, gen=gen).to(dev),
                               Discriminator(geo, gen=gen).to(dev))
    real = mesh.rows(torch.rand(TRAIN_BATCH, 64, 64, 3, generator=torch.Generator().manual_seed(1))
                     * 2 - 1).to(dev)
    steps = {"mesh": make_dcgan_train_step(cfg, geo, mesh)}
    if spec["backend"] == "nccl":
        steps["plain"] = make_dcgan_train_step(cfg, geo)
        turns = ["plain", "mesh", "mesh", "plain"]
    else:
        turns = ["mesh", "mesh"]

    def timed(step, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            step(state, real)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    for step in steps.values():
        timed(step, 2)  # warm
    ms = {name: [] for name in steps}
    for name in turns:
        ms[name] += timed(steps[name], MESH_TIMED)
    counts: dict = {}
    restore = _count_collectives(counts)
    try:
        t0 = time.perf_counter()
        timed(steps["mesh"], 1)
        one_step_s = time.perf_counter() - t0
    finally:
        restore()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed(steps["mesh"], 3)
        window_us = 1e6 * (time.perf_counter() - t0)
    comm = {}
    for e in prof.key_averages():
        name = e.key.lower()
        if name.startswith(("gloo:", "nccl:")) or "nccldevkernel" in name or "c10d::" in name:
            comm[e.key] = (e.cpu_time_total, getattr(e, "device_time_total",
                                                     getattr(e, "cuda_time_total", 0.0)), e.count)
    dev_comm = sum(d for _, d, _ in comm.values() if d)
    rec = {"ms": ms, "counts": counts, "host_share": counts.get("host_s", 0.0) / one_step_s,
           "profiler_comm": {k: list(v) for k, v in sorted(comm.items(), key=lambda kv: -kv[1][0])},
           "window_us": window_us, "device_comm_us": dev_comm, "rank": dist.get_rank()}
    torch.save(rec, f"{spec['out']}.rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


def _ft_step_run(dev, mesh=None, perturb: float = 0.0, steps: int = 2) -> list:
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
    net = tiv.init(0, num_classes=100)
    if perturb:
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=torch.Generator().manual_seed(5)))
    net = net.to(dev)
    step = make_train_step(net, make_optimizer(net, 0.1), torch.float32, FT_SIZE, mesh)
    draws_gen = torch.Generator().manual_seed(12)
    snaps = [tiv.to_jckx_flat(net)]
    for _ in range(steps):
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
    fba.LAUNCHES = 0
    snaps = _ft_step_run(dev, make_mesh((2,), device=dev))
    rec = {"launches": fba.LAUNCHES}
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


def child_time_model(spec: dict) -> None:
    """bf16 DCGAN steps at full width (global batch 128) on a gloo pair of
    this card laid out as a (1, 2) mesh in ``spec["mode"]``: host ms per
    step (each synchronised; ``MESH_WARM`` untimed, then ``MESH_TIMED``),
    and over the timed steps the mesh's collectives by kind (calls and
    bytes per step) and their host share of the step."""
    import torch
    import torch.distributed as dist

    from jckx_torch.configs import Config
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.parallel import make_mesh
    from jckx_torch.train.state import create_dcgan_state
    from jckx_torch.train.steps import make_dcgan_train_step

    dev = _child_init("gloo")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
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
    ms = []
    for i in range(MESH_WARM + MESH_TIMED):
        if i == MESH_WARM:
            mesh.stats.reset()
        t0 = time.perf_counter()
        step(state, real)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    timed = ms[MESH_WARM:]
    stats = mesh.stats.as_dict()
    host_s = sum(v["host_s"] for v in stats.values())
    rec = {"ms": timed, "per_step": {k: {"calls": v["calls"] / MESH_TIMED,
                                         "bytes": v["bytes"] / MESH_TIMED,
                                         "host_ms": 1e3 * v["host_s"] / MESH_TIMED}
                                     for k, v in stats.items()},
           "host_share": host_s / (1e-3 * sum(timed)), "rank": dist.get_rank()}
    torch.save(rec, f"{spec['out']}.rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


def child_first_step(spec: dict) -> None:
    """One DCGAN step at full width (batch 128) from the trainer's initial
    weights on a seeded batch, on ``spec["device"]`` (the card, or the CPU
    with ``GAP_THREADS`` threads), alone (``mode`` "") or as a gloo rank of
    a (1, 2) mesh in ``spec["mode"]``; f32, or with ``spec["f64"]`` the
    step's compute in f64 (its compute dtype patched; the parameters and
    Adam stay f32). Rank 0 saves the step's telemetry to ``<out><mode>.pt``."""
    import torch
    import torch.distributed as dist

    from jckx_torch.configs import Config
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.parallel import make_mesh
    from jckx_torch.train import steps
    from jckx_torch.train.state import create_dcgan_state
    from jckx_torch.train.steps import make_dcgan_train_step

    if spec.get("f64"):
        steps.compute_dtype = lambda cfg: torch.float64
    card = _child_init("gloo" if spec["mode"] else "none")
    dev = card if spec["device"] == "cuda" else torch.device("cpu")
    torch.set_num_threads(GAP_THREADS)
    mesh = make_mesh((1, 2), ("data", "model"), device=dev) if spec["mode"] else None
    cfg, geo = Config(), GANGeometry()
    cfg.compute_dtype, cfg.max_learning_rate = "float32", TRAIN_LR
    cfg.model_axis_mode = spec["mode"] or cfg.model_axis_mode
    gen = torch.Generator().manual_seed(12345)  # the trainer's seed
    state = create_dcgan_state(cfg, Generator(geo, gen=gen).to(dev),
                               Discriminator(geo, gen=gen).to(dev), mesh)
    real = (torch.rand(TRAIN_BATCH, 64, 64, 3, generator=torch.Generator().manual_seed(1))
            * 2 - 1).to(dev)
    m = make_dcgan_train_step(cfg, geo, mesh)(state, real)
    if not dist.is_initialized() or dist.get_rank() == 0:
        torch.save({k: float(v) for k, v in m.items()}, f"{spec['out']}{spec['mode']}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()


def child_planes(spec: dict) -> None:
    """``phase_data_planes`` in a process of its own: in the script's
    process, after its earlier profiler windows and CUDA graphs, the
    profiler missed the slab's host→device copy in 7 of 7 windows over 5
    full runs on an H100 (fresh processes: 6 of 6 recorded), and the
    phase's profiled launch reads it. Writes its launches to
    ``spec["out"]``."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    launches = phase_data_planes(spec["tmp"], dev, spec["card"])
    with open(spec["out"], "w") as f:
        json.dump({"launches": launches}, f)


def phase_data_planes_alone(tmp: str, card: str) -> int:
    """``phase_data_planes`` in a child process (``child_planes``), its
    lines printed here. → its kernel launches."""
    out = os.path.join(tmp, "planes_out.json")
    (stdout,) = _join([_start_child("planes", {"tmp": tmp, "card": card, "out": out})],
                      "phase_data_planes", timeout=900)
    print(stdout, end="")
    with open(out) as f:
        return json.load(f)["launches"]


CHILDREN = {"train": child_train, "time": child_time, "finetune": child_finetune,
            "time_model": child_time_model, "first_step": child_first_step,
            "planes": child_planes}


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


def phase_mesh_serve(path: str, svc, dev, card: str) -> int:
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
    fba.LAUNCHES = 0
    got = two.sample(n, seed=5)
    launches = fba.LAUNCHES
    check(launches == 4 * 2 * 4, f"the mesh service launched {launches} kernels for 4 batches, "
                                 f"want 32 (4 per device per batch)")
    want = svc.sample(n, seed=5)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    exact = float((diff == 0).mean())
    check(diff.max() <= 1 and exact >= 0.99,
          f"sharded renders vs unsharded: max {diff.max()} LSB, {100 * exact:.4f} % exact")
    rates = {}
    for name, s in (("unsharded", svc), ("mesh", two), ("mesh", two), ("unsharded", svc)):
        t0 = time.perf_counter()
        s.sample(8 * BATCH, seed=1)
        rates.setdefault(name, []).append(8 * BATCH / (time.perf_counter() - t0))
    print(f"serving over a local mesh [cuda:0, cuda:0] (bs{BATCH} bf16, each device 256 rows, "
          f"global statistics): {launches} kernel launches for 4 batches (4 per device per "
          f"batch); against the unsharded service on the same requests max {diff.max()} LSB, "
          f"{100 * exact:.4f} % exactly equal; served img/s, in turns: mesh "
          f"{[round(r, 1) for r in rates['mesh']]}, unsharded "
          f"{[round(r, 1) for r in rates['unsharded']]}   [{card}]")
    return launches


def phase_mesh(tmp: str, dev, card: str) -> int:
    """The data axis of the mesh at full width (64², base width 64, global
    batch 128, ``MESH_STEPS`` steps and one eval of each run, f32, TF32
    off), in child processes (``--child``), most at once:

    - the plain single-rank run of DCGAN and of CGAN (K = 100), and DCGAN
      on a NCCL world of one (``--mesh_shape 1 --multihost`` from
      ``env://``): its parameters bit-identical to the plain run's;
    - two gloo ranks on this card (``--device cuda:0`` each, gloo copying
      each collective through the host), DCGAN and CGAN, against the plain
      run by ``phase_train_vs_cpu``'s one-step criteria on their first
      step (telemetry within 3e-3, masked Adam deltas); the last step's
      telemetry gap is printed with every step's, not held: GAN training at
      full width parts the two runs about tenfold a step from the
      reassociated sums of the first, where the plain run repeats itself
      bit for bit. The kernel runs on each rank's rows at the eval, after
      the statistics' all-reduce;
    - two fine-tune steps at 299², 8 rows per rank, f32 on the gloo pair
      against the single rank in this process: the first step's deltas
      within 10 % in norm per leaf; the second's printed beside the single
      rank's own gap against weights perturbed by 1e-7 (the seeded random
      backbone's second step is chaotic: tests/test_torch_dp_metrics.py);

    then, alone, the bf16 step timed: the NCCL world of one in turns
    against no mesh, and the gloo pair; collectives per step by kind and
    their share of the step. → the kernel launches of the mesh runs."""
    import numpy as np
    import torch

    from jckx_torch.kernels import fused_bn_act as fba

    t_phase = time.perf_counter()
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
    # the single-rank fine-tune reference, and its noise floor, here meanwhile
    ft_one = _ft_step_run(dev)
    ft_floor = _ft_step_run(dev, perturb=1e-7)
    for name, ps in procs.items():
        _join(ps, f"phase_mesh {name}")
    load = lambda name, r=0: torch.load(os.path.join(out, f"{name}.rank{r}.pt"),  # noqa: E731
                                        weights_only=False)
    runs = {name: [load(name, r) for r in range(len(ps))] for name, ps in procs.items()}
    first_s = time.perf_counter() - t_phase

    # (1) NCCL world of one against the plain run: bit for bit
    plain, nccl = runs["plain"][0], runs["nccl"][0]
    for net in ("G", "D"):
        for k, v in plain[net].items():
            check(torch.equal(nccl[net][k], v), f"NCCL world of one: {net}.{k} differs from the "
                                                f"plain run after {MESH_STEPS} steps")
    check(nccl["step"] == plain["step"] == MESH_STEPS and nccl["launches"] == 4,
          f"NCCL world of one: step {nccl['step']}, {nccl['launches']} launches (want 4)")
    n_params = sum(v.numel() for net in ("G", "D") for v in plain[net].values())
    print(f"NCCL world of one (--mesh_shape 1 --multihost, env://) against the plain run: "
          f"{n_params:,} parameter values bit-identical after {MESH_STEPS} steps (DCGAN 64², "
          f"width 64, bs{TRAIN_BATCH}, f32, deterministic algorithms); 4 kernel launches at its "
          f"eval   [{card}]")

    # (2) the gloo pairs against the plain runs
    launches = nccl["launches"]
    for model, pair, ref in (("DCGAN", "gloo", "plain"), ("CGAN", "gloo_cgan", "plain_cgan")):
        r0, r1 = runs[pair]
        one = runs[ref][0]
        want = 4 if model == "DCGAN" else 8  # per rank: 1 forward of 32 rows; 2 chunks of 250
        check(r0["launches"] == r1["launches"] == want and r0["evals"] == [MESH_STEPS],
              f"{model} gloo pair: launches {r0['launches']} / {r1['launches']}, want {want} per "
              f"rank; evals {r0['evals']}")
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
              f"the eval (each rank's rows, after the statistics' all-reduce)   [{card}]")

    # (3) the fine-tune pair against the single rank
    ft = runs["finetune"]
    check(ft[0]["launches"] == ft[1]["launches"] == 2 * FT_CONVS,
          f"fine-tune pair launches {ft[0]['launches']} / {ft[1]['launches']}, want {2 * FT_CONVS}")
    launches += ft[0]["launches"] + ft[1]["launches"]
    snaps = ft[0]["snaps"]
    for s in (1, 2):
        d_one = _flat_deltas(ft_one[0], ft_one[s])
        d_dp, d_fl = _flat_deltas(ft_one[0], snaps[s]), _flat_deltas(ft_floor[0], ft_floor[s])
        gap = {k: abs(float(np.linalg.norm(d_dp[k])) - float(np.linalg.norm(d_one[k])))
               / float(np.linalg.norm(d_one[k])) for k in d_one if np.linalg.norm(d_one[k]) > 0}
        floor = [abs(float(np.linalg.norm(d_fl[k])) - float(np.linalg.norm(d_one[k])))
                 / float(np.linalg.norm(d_one[k])) for k in gap]
        worst = max(gap, key=gap.get)
        check(all(math.isfinite(v) for v in gap.values()), f"fine-tune pair step {s}: non-finite")
        if s == 1:
            check(gap[worst] <= 0.1, f"fine-tune pair step 1: {worst}'s delta norm {gap[worst]:.3g} "
                                     f"from the single rank's")
        print(f"fine-tune on two gloo ranks (299², {FT_MESH_BATCH} rows per rank, f32, lr 0.1) "
              f"against one rank, after step {s}: delta norms at worst {gap[worst]:.3g} apart "
              f"({worst}), median {statistics.median(gap.values()):.3g}"
              + (" (<= 0.1)" if s == 1 else " (not held: chaotic)")
              + f"; one rank against its weights perturbed by 1e-7: at worst {max(floor):.3g}, "
                f"median {statistics.median(floor):.3g}; {2 * FT_CONVS} launches per rank   "
                f"[{card}]")

    # (4) timing, alone: the NCCL world of one against no mesh, then the gloo pair
    t0 = time.perf_counter()
    _join([_start_child("time", spec("time_nccl", backend="nccl"), 0, 1, _free_port())],
          "phase_mesh time_nccl")
    _join(_start_group("time", spec("time_gloo", backend="gloo"), 2), "phase_mesh time_gloo")
    timing_s = time.perf_counter() - t0
    tn = load("time_nccl")
    tg = [load("time_gloo", r) for r in range(2)]
    med = {k: statistics.median(v) for k, v in tn["ms"].items()}
    gloo_ms = [statistics.median(t["ms"]["mesh"]) for t in tg]
    numbers = {"card": card, "nccl1_step_ms": med["mesh"], "plain_step_ms": med["plain"],
               "nccl1_ms_turns": tn["ms"], "gloo_step_ms_per_rank": gloo_ms,
               "collectives_per_step": tg[0]["counts"], "nccl1_collectives": tn["counts"],
               "gloo_host_share": [t["host_share"] for t in tg],
               "nccl1_host_share": tn["host_share"], "nccl1_device_comm_us": tn["device_comm_us"],
               "gloo_profiler_comm": tg[0]["profiler_comm"],
               "nccl1_profiler_comm": tn["profiler_comm"],
               "first_s": first_s, "timing_s": timing_s}
    c = tg[0]["counts"]

    def c10d_share(t):  # the profiler's c10d ops' host time over its window
        return sum(v[0] for k, v in t["profiler_comm"].items() if k.startswith("c10d::")) \
            / t["window_us"]

    numbers["profiler_c10d_share"] = {"gloo": c10d_share(tg[0]), "nccl1": c10d_share(tn)}
    print(f"bf16 DCGAN step (64², width 64, bs{TRAIN_BATCH} global): NCCL world of one "
          f"{med['mesh']:.3f} ms against {med['plain']:.3f} ms without a mesh (medians of "
          f"{2 * MESH_TIMED}, in turns plain, mesh, mesh, plain); two gloo ranks on this card "
          f"{gloo_ms[0]:.3f} / {gloo_ms[1]:.3f} ms per rank; collectives per step "
          f"{c.get('bn_stats', 0)} BN-statistics all-reduces, {c.get('grads', 0)} gradient "
          f"all-reduces, {c.get('other', 0)} other, {c.get('all_gather', 0)} all-gathers; their "
          f"host share of a step (host clock around each call): gloo "
          f"{100 * tg[0]['host_share']:.1f} %, NCCL world of one {100 * tn['host_share']:.1f} %; "
          f"the profiler's c10d ops over its 3-step window: gloo "
          f"{100 * numbers['profiler_c10d_share']['gloo']:.1f} %, NCCL world of one "
          f"{100 * numbers['profiler_c10d_share']['nccl1']:.1f} %   [{card}]")
    print("mesh_numbers " + json.dumps(numbers))
    print(f"phase_mesh: {time.perf_counter() - t_phase:.1f} s ({first_s:.1f} s the runs at once, "
          f"{timing_s:.1f} s the timing); {launches} kernel launches on the mesh runs")
    return launches


def phase_mesh_model(tmp: str, card: str) -> int:
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
      (``MODEL_GRAD_GAP`` says why), beside the noise floor of the plain
      run from weights nudged by ``MODEL_FLOOR``;
    - DCGAN under ``spatial --spatial_replicate_grads 0`` (Adam on each
      rank's half of the flat parameters) against ``1``: the first step's
      parameters within 1e-6 of each leaf's largest magnitude, the last
      step's gap printed;
    - the eval of each run: the kernel's launches on every rank (a TP
      generator all-gathered first, then 4 per DCGAN render, 8 per CGAN
      render), and the render bit-identical to ``bn_act_one_rounding``;
    - the TP run's ``latest.ckpt`` (full tensors) served by
      ``GeneratorService`` (4 launches for a batch of 64);

    then the bf16 step of a TP pair and of a spatial pair (2 warm + 6
    timed steps): ms per rank, the collectives per step by kind and their
    host share. → the kernel launches of the runs' evals and the serve."""
    import torch

    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.serve import GeneratorService

    t_phase = time.perf_counter()
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
    # the comparison's noise floor: the plain run from weights nudged by 1e-6
    procs["floor"] = [_start_child("train", {
        "backend": "none", "perturb": MODEL_FLOOR, "out": os.path.join(out, "floor"),
        "argv": _mesh_argv(tmp, "DCGAN", "floor", ["--device", "cuda"])})]
    for name, ps in procs.items():
        _join(ps, f"phase_mesh_model {name}")
    load = lambda name, r=0: torch.load(os.path.join(out, f"{name}.rank{r}.pt"),  # noqa: E731
                                        weights_only=False)
    res = {name: [load(name, r) for r in range(2)] for name in runs}
    plain = {"DCGAN": load("plain"), "CGAN": load("plain_cgan")}
    runs_s = time.perf_counter() - t_phase
    floor = load("floor")["first"]
    print(f"noise floor: the plain DCGAN run from weights nudged by {MODEL_FLOOR:g} relative "
          f"against the plain run, step 1: telemetry max |diff| "
          f"{max(abs(floor['telemetry'][k] - plain['DCGAN']['first']['telemetry'][k]) for k in floor['telemetry']):.3g}; "
          + _gaps_text(_pair_gaps(_init_params("DCGAN"), floor, plain["DCGAN"]["first"]))
          + f" (not held)   [{card}]")
    launches = 0
    for name, (model, _) in runs.items():
        r0, r1 = res[name]
        one = plain[model]
        want = 4 if model == "DCGAN" else 8  # one render of 64, or 1000 rows in chunks of 500
        check(r0["launches"] == r1["launches"] == want and r0["evals"] == [MESH_STEPS],
              f"{name}: launches {r0['launches']} / {r1['launches']}, want {want} per rank; "
              f"evals {r0['evals']}")
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
              f"{r0['renders_equal_once'][1]} bit-identical to bn_act_one_rounding   [{card}]")
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
              + (" (<= 1e-6)" if when == "first" else " (not held)") + f"   [{card}]")

    # the TP run's checkpoint, served
    ckpt = os.path.join(tmp, "mesh_save", "tp", "dcgan", "tp", "latest.ckpt")
    svc = GeneratorService(ckpt, batch_size=64, compute_dtype=torch.bfloat16, device="cuda")
    before = fba.LAUNCHES
    images = svc.sample(64, seed=0)
    served = fba.LAUNCHES - before
    check(images.shape == (64, 64, 64, 3) and svc.step == MESH_STEPS and served == 4,
          f"the TP checkpoint served {images.shape} at step {svc.step} with {served} launches")
    launches += served
    print(f"the TP run's latest.ckpt (full tensors, step {svc.step}) served by GeneratorService: "
          f"64 images, {served} kernel launches   [{card}]")

    # the bf16 step of each layout, timed
    t0 = time.perf_counter()
    for mode in ("tp", "spatial"):
        _join(_start_group("time_model", {"mode": mode, "out": os.path.join(out, f"time_{mode}")},
                           2), f"phase_mesh_model time_{mode}")
    timing_s = time.perf_counter() - t0
    numbers = {"card": card, "runs_s": runs_s, "timing_s": timing_s}
    for mode in ("tp", "spatial"):
        t = [load(f"time_{mode}", r) for r in range(2)]
        med = [statistics.median(x["ms"]) for x in t]
        numbers[mode] = {"step_ms_per_rank": med, "ms": [x["ms"] for x in t],
                         "collectives_per_step": t[0]["per_step"],
                         "host_share": [x["host_share"] for x in t]}
        c = t[0]["per_step"]
        kinds = ", ".join(f"{k} {v['calls']:g} calls / {v['bytes'] / 2**20:.2f} MiB / "
                          f"{v['host_ms']:.2f} ms" for k, v in c.items() if v["calls"])
        print(f"bf16 DCGAN step (64², width 64, bs{TRAIN_BATCH}) under {mode} on a (1, 2) mesh "
              f"of two gloo ranks of this card: {med[0]:.3f} / {med[1]:.3f} ms per rank "
              f"(medians of {MESH_TIMED} after {MESH_WARM} warm steps); collectives per step "
              f"(rank 0): {kinds}; their host share of a step {100 * t[0]['host_share']:.1f} % / "
              f"{100 * t[1]['host_share']:.1f} %   [{card}]")

    # the spatial pair's first step against the plain step, on the card (f32,
    # f64) and on the CPU (f32): which fields differ, and whether without
    # cuDNN or in f64
    t0 = time.perf_counter()
    numbers["first_step_gaps"] = gaps = _first_step_gaps(out)
    for where, by_field in gaps.items():
        print(f"first DCGAN step (64², width 64, bs{TRAIN_BATCH}, the same weights, batch and "
              f"draws) of a spatial (1, 2) gloo pair against the plain step on the {where}: "
              f"|diff| by field {_fields_text(by_field)}   [{card}]")
    gaps_s = time.perf_counter() - t0
    numbers["gaps_s"] = gaps_s
    print("mesh_model_numbers " + json.dumps(numbers))
    print(f"phase_mesh_model: {time.perf_counter() - t_phase:.1f} s ({runs_s:.1f} s the runs at "
          f"once, {timing_s:.1f} s the timing, {gaps_s:.1f} s the first-step control); "
          f"{launches} kernel launches")
    return launches, numbers


def _fields_text(gaps: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())


FIRST_STEP_RUNS = {"card": ("cuda", False), "card, computed in f64": ("cuda", True),
                   "CPU": ("cpu", False)}  # name: (device, f64)


def _first_step_gaps(out: str) -> dict:
    """``child_first_step`` on the card in f32 and in f64 and on the CPU in
    f32, each alone and as a spatial gloo pair, all at once. → {run name
    (``FIRST_STEP_RUNS``): {field: |pair - plain|}} of the first step's
    telemetry."""
    import torch

    procs = []
    for i, (where, f64) in enumerate(FIRST_STEP_RUNS.values()):
        spec = {"device": where, "f64": f64, "out": os.path.join(out, f"first_{i}")}
        procs += [_start_child("first_step", {**spec, "mode": ""})]
        procs += _start_group("first_step", {**spec, "mode": "spatial"}, 2)
    _join(procs, "phase_mesh_model first-step control", timeout=600)
    gaps = {}
    for i, name in enumerate(FIRST_STEP_RUNS):
        load = lambda mode: torch.load(  # noqa: E731
            os.path.join(out, f"first_{i}{mode}.pt"), weights_only=False)
        plain, pair = load(""), load("spatial")
        gaps[name] = {k: abs(pair[k] - plain[k]) for k in plain}
    return gaps


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


def phase_plan(dev, card: str, train_t: dict, mesh_model: dict) -> dict:
    """``python -m jckx_torch plan --device cuda`` at the reference geometry
    (``PLAN_RUNS``, all at once): every report's memory read on the card
    and fitting; the TP and spatial reports' collectives per kind equal to
    ``phase_mesh_model``'s gloo pairs' per bf16 step (``mesh_model``), and
    their bytes: the report counts a 16-bit tensor at its own width, gloo
    sends it as f32, so 2 x the report's bf16 bytes + its f32 bytes equal
    gloo's. Prints the unsharded step's floors beside its device ms from
    ``phase_train_timing`` (``train_t``), the planned memory beside a real
    one-card step's, and the f32 FLOPs beside jckx's count (within 25 %).
    Launches no kernel: the planned step is differentiated."""
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.utils.comm import HLO_OPS  # the mesh's kinds → the report's op names

    t0 = time.perf_counter()
    launches = fba.LAUNCHES
    here = os.path.dirname(os.path.abspath(__file__))
    base = ["-m", "DCGAN", "-b", str(TRAIN_BATCH), "--image_size", "64", "--base_width", "64",
            "--device", "cuda"]
    procs = {name: subprocess.Popen([sys.executable, "-m", "jckx_torch", "plan", *base, *flags],
                                    cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, flags in PLAN_RUNS.items()}
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
              f"{r['per_chip']['step_flops']:.4g} FLOP, {r['per_chip']['step_hbm_bytes']:.4g} "
              f"bytes (unfused), memory {mem}, collectives (calls, bytes) {ops}, floors "
              f"{r['step_floors_us']} µs, bound {r['bound']}   [{card}]")
    for mode in ("tp", "spatial"):
        gloo = mesh_model[mode]["collectives_per_step"]
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
        print(f"plan {mode}: collectives per kind equal to the gloo pair's per bf16 step "
              f"(phase_mesh_model), bytes equal once gloo's widening to f32 is undone: "
              f"{inventory}   [{card}]")
    one = reports["one"]
    floors, busy_ms = one["step_floors_us"], train_t["step_ms_card"]
    shares = {k: v / (1e3 * busy_ms) for k, v in floors.items()} if busy_ms else {}
    print(f"the unsharded bf16 DCGAN step's floors {floors} µs (bound {one['bound']}) beside its "
          f"device busy time {busy_ms} ms (phase_train_timing): the floors' shares of it "
          + ", ".join(f"{k} {100 * v:.2f} %" for k, v in shares.items()) + f"   [{card}]")
    real = _real_step_memory(dev)
    mem = one["per_chip"]["memory"]
    check(abs(mem["temp_mb"] - real["temp_mb"]) <= 0.25 * real["temp_mb"],
          f"planned step temporaries {mem['temp_mb']} MB against a real step's "
          f"{real['temp_mb']:.1f} MB")
    print(f"planned memory of the unsharded bf16 step: peak {mem['peak_mb']} MB, arguments "
          f"{mem['argument_mb']} MB, temporaries {mem['temp_mb']} MB; a real one-card step "
          f"(torch.cuda.max_memory_allocated, less what this process held before it): peak "
          f"{real['peak_mb']:.1f} MB, arguments {real['argument_mb']:.1f} MB, temporaries "
          f"{real['temp_mb']:.1f} MB   [{card}]")
    flops = reports["one_f32"]["per_chip"]["step_flops"]
    ratio = flops / JCKX_PLAN_F32_FLOPS
    check(0.75 <= ratio <= 1.25, f"plan's f32 step FLOPs {flops:.4g} against jckx's "
                                 f"{JCKX_PLAN_F32_FLOPS:.4g}")
    print(f"the unsharded f32 step: {flops:.4g} FLOP (torch.utils.flop_counter's registry) "
          f"against jckx.plan's {JCKX_PLAN_F32_FLOPS:.4g} (XLA's cost analysis): {ratio:.4f}x; "
          f"bf16 {one['per_chip']['step_flops']:.4g}   [{card}]")
    check(fba.LAUNCHES == launches, f"the planner launched the kernel "
                                    f"{fba.LAUNCHES - launches} times in this process")
    seconds = time.perf_counter() - t0
    numbers = {"card": card, "reports": reports, "real_step_memory": real,
               "floor_shares": shares, "flops_vs_jckx": ratio, "seconds": seconds}
    print("plan_numbers " + json.dumps(numbers))
    print(f"phase_plan: {seconds:.1f} s; 0 kernel launches")
    return numbers


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

    kind, card = phase_environment()
    lap("start")
    phase_build()
    max_err = phase_kernel_vs_plain(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dcgan_seed0.pt")
        geo = write_reference_checkpoint(path)
        svc, launches = phase_serve(path, geo)
        cgan_path = os.path.join(tmp, "cgan_seed0.pt")
        write_reference_checkpoint(cgan_path, conditional=True)
        csvc, cgan_launches = phase_serve_cgan(cgan_path, geo, dev)
        phase_int8_exact(dev)
        modes, mode_launches = phase_serve_modes(path, cgan_path, svc, dev)
        http_launches, _ = phase_http(svc, csvc, card)
        _, export_launches = phase_export(path, cgan_path, svc, tmp, dev, card)
        phase_tools(path, os.path.join(tmp, "dcgan_bf16.pt2"), tmp, kind)
        mesh_serve_launches = phase_mesh_serve(path, svc, dev, card)
    lap("build, serving, HTTP, export, tools, mesh serving")
    phase_serve_vs_plain(svc, dev)
    phase_serve_vs_plain(csvc, dev)
    t = phase_timing(svc, dev, card)
    phase_profile(svc, card)
    phase_modes_timing(svc, modes, dev, card)
    phase_train_vs_cpu(dev)
    phase_train_vs_cpu(dev, conditional=True)
    phase_train_vs_cpu(dev, fused_prop=1)
    phase_train_vs_cpu(dev, conditional=True, fused_prop=1)
    phase_remat(dev, card)
    phase_sanitize(dev)
    phase_bn_relu_train(dev, card)
    phase_finetune_vs_cpu(dev)
    lap("timings, card-vs-CPU steps, remat, sanitize, bn_relu_train")
    with tempfile.TemporaryDirectory() as tmp:
        step8 = os.path.join(tmp, "dcgan_step8.ckpt")
        with keep_latest_of_step(8, step8):
            tr, steps, _, train_launches = phase_train(tmp)
        watch_launches = phase_watch(step8, os.path.join(tr.save_path, "latest.ckpt"), tmp)
        train_t = phase_train_timing(tr, steps, tmp, card)
        fused_launches = phase_fused_prop_train(tmp, card)
        fused_launches += phase_profile_dir(tmp, card)
        fused_launches += phase_jckx_ckpt(tmp, dev, card)
        ctr, csteps, cevals, ctrain_launches = phase_train(tmp, "CGAN")
        eval_launches = phase_evaluate(ctr, cevals, tmp)
        eval_launches += phase_evaluate_int8(ctr, tmp)
        eval_launches += phase_extra_metrics(ctr, tmp, dev, card)
        phase_train_timing(ctr, csteps, tmp, card)
        panel_launches = phase_panel(tmp, card)
        finetune_launches = phase_finetune(ctr, tmp, card)
        lap("training, evaluate, panel, fine-tune")
        inference_launches = phase_inference_graph(tmp, dev, card, tr, ctr)
        lap("phase_inference_graph")
        # the children below share the card: free the trainers' graphs first
        del tr, ctr
        gc.collect()
        torch.cuda.empty_cache()
        plane_launches = phase_data_planes_alone(tmp, card)
        lap("phase_data_planes")
        mesh_launches = phase_mesh(tmp, dev, card)
        model_launches, mesh_model = phase_mesh_model(tmp, card)
        mesh_launches += model_launches
        lap("phase_mesh, phase_mesh_model")
        superstep_launches = phase_superstep(tmp, dev, card)
        lap("phase_superstep")
    phase_plan(dev, card, train_t, mesh_model)
    lap("phase_plan")
    print(json.dumps({"kernels": [{
        "name": "fused_bn_act", "route": "cuda",
        "source": "jckx_torch/kernels/csrc/fused_bn_act.cu",
        "replaces": "jckx/kernels/fused_bn_act.py:120",
        "launches": (launches + train_launches + cgan_launches + ctrain_launches + eval_launches
                     + mode_launches + http_launches + watch_launches + export_launches
                     + panel_launches + finetune_launches + fused_launches + plane_launches
                     + mesh_serve_launches + mesh_launches + superstep_launches
                     + inference_launches),
        "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--child":  # a child of phase_mesh(_model)
        CHILDREN[sys.argv[2]](json.loads(sys.argv[3]))
    else:
        main()
