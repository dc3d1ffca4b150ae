"""InceptionV3 fine-tuning, the metric-backbone trainer — port of
``jckx/metrics/inception_train.py``.

    python -m jckx_torch finetune --dataset cifar100 -e 300
    python -m jckx_torch.metrics.inception_train --dataset synthetic --synthetic_size 2560 -e 2

The reference's offline notebook (inceptionnet.ipynb): torchvision's
InceptionV3 with a K-class head, nesterov SGD (lr 0.1, momentum 0.9,
weight decay 5e-4) at batch 128, RandomResizedCrop(299) + flip, per-epoch
top-1 / top-5 / superclass accuracy and cross-entropy on the test split,
early stopping on a patience counter, and the best-accuracy / best-loss /
last weights as ``acc_bset.npz`` / ``loss_bset.npz`` / ``last_bset.npz``
in jckx's flat layout, which both packages' ``Metrics`` load as
``--metric_backbone``.

One train step (``make_train_step``): gather the batch by index from the
uint8 set resident on the device, /255, crop + flip to ``image_size`` on
the device (``data/augment.py``), ImageNet normalization, the train-mode
forward in the compute dtype (``InceptionV3.forward_train``: batch-stat BN
through ``ops/norm.bn_relu_train``, whose normalize pass is the hand
kernel on the card, 94 launches per step), mean cross-entropy and
accuracy, backward, SGD. On the card the step is one CUDA graph, as
jckx's step is one ``jax.jit`` program (``:97-104``): captured after the
run's first step, which runs eagerly, and replayed (``train/superstep.py``;
the draws are made on the host into the graph's inputs, and the batch's
indices copied in). Launches go as jckx's (``:496-530``): ``--scan_steps
K`` replays K steps per launch and reads their loss once, at its end, to
log its mean (jckx's ``make_superstep``, ``:107-130``); ``0`` replays one
step per launch. Either way the host reads the epoch's loss and accuracy
once, at its end. ``prepare`` builds the state (net, SGD, step, resident
data, generator, superstep) and ``launch`` runs one launch of it; ``train``
is the epoch loop, evals and files around the two, and the benchmark
(``portbench/traffic/finetune.py``) calls the same two. Under a profiler a
launch is the span ``finetune.launch``, each step's host part (its index
slice and draws) ``train.feed``, as the GAN trainer's, its read
``finetune.telemetry_read``.
Over a NCCL mesh the graph holds the step's collectives
(``bn_relu_train``'s all-reduces, the gradient average, the loss and
accuracy means); over gloo, whose collectives run on the host, and on the
CPU the steps stay eager, and the log says why. The eval forward folds the
running statistics into plain BN, as jckx's, and launches no kernel.

Random draws (crop boxes, flips, dropout masks) come from one
``torch.Generator`` on the device seeded with ``--seed``; a step takes
them as a ``StepDraws``, so a test can inject jckx's. ``train_state.npz``
holds the weights, the momentum buffers, the epoch, patience, bests and
the generator's state in one atomic file, and ``--resume 1`` continues
from it exactly.

Custom data, as jckx's (``:351-372``): ``--dataset npz`` or ``folder``
(a directory of images, class subdirectories as labels, stored at
``--image_size``) with ``--data_path``, and the valid split from
``--valid_data_path`` or a seeded 10 % holdout. A cached archive's
read-only mapping is copied once on upload.

Data parallel (``--mesh_shape N``, ``--multihost``; jckx ``:107-160``,
``:187-257``, ``:338-445``): one process per GPU (``torchrun
--nproc_per_node N -m jckx_torch finetune --mesh_shape N --multihost``); a
run on a process group of more than one rank always trains over it. Every
rank draws the global batch's crops and dropout masks from the same
generator and keeps its rows; BN takes the global statistics through
``bn_relu_train``'s all-reduces; the gradients are averaged over the ranks
through one flat buffer before SGD; the loss and accuracy are the global
ones. The eval split is held by every rank, each takes its rows of every
batch and the logits are gathered in order. Rank 0 alone writes the
``.npz`` files, ``train_state.npz``, ``summary.json`` and the log; every
rank reads ``train_state.npz`` on ``--resume 1``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from jckx_torch.data.augment import CropDraws, draw_crops, random_resized_crop_flip
from jckx_torch.data.datasets import FINE_TO_SUPERCLASS, load_dataset
from jckx_torch.data.pipeline import device_copy, resize_bilinear
from jckx_torch.logging.main_logger import MainLogger, time_to_str
from jckx_torch.metrics import inception_v3
from jckx_torch.metrics.metrics import IMAGENET_MEAN, IMAGENET_STD
from jckx_torch.parallel.mesh import parse_mesh_shape, process_mesh
from jckx_torch.train.superstep import Superstep, graph_for
from jckx_torch.utils import spans
from jckx_torch.utils.device import multihost_barrier, resolve_device

FEATURES = 2048  # the pooled width that dropout masks
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class StepDraws(NamedTuple):
    """One step's random draws: the crops and the dropout keep mask
    (N, 2048) bool."""
    crops: CropDraws
    keep: torch.Tensor


def draw_step(generator: torch.Generator, n: int, device=None) -> StepDraws:
    """One step's draws for a batch of ``n`` from ``generator``."""
    return StepDraws(draw_crops(n, generator, device),
                     torch.rand(n, FEATURES, generator=generator, device=device) < 0.5)


def shard_step_draws(draws: StepDraws, mesh) -> StepDraws:
    """This rank's rows of a global batch's draws."""
    if mesh is None:
        return draws
    return StepDraws(CropDraws(*(mesh.rows(t) for t in draws.crops)), mesh.rows(draws.keep))


def make_optimizer(net: inception_v3.InceptionV3, lr: float, weight_decay: float = 5e-4,
                   momentum: float = 0.9, nesterov: bool = True) -> torch.optim.SGD:
    """Turn on the gradients of the net's parameters (conv weights, BN
    affine, fc) and → SGD over them. The running statistics are buffers,
    so no decay or momentum reaches them: jckx's mask (``:48-64``). torch
    decays before momentum and its nesterov step is ``g + μ·buf`` with
    the buffer starting at g, which is optax's ``add_decayed_weights`` →
    ``trace(nesterov)``."""
    net.requires_grad_(True)
    return torch.optim.SGD(net.parameters(), lr=lr, momentum=momentum, nesterov=nesterov,
                           weight_decay=weight_decay)


def _normalizer(device):
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
    return lambda x: (x - mean) / std


def make_train_step(net: inception_v3.InceptionV3, opt: torch.optim.Optimizer,
                    compute_dtype=torch.bfloat16, image_size: int = 299, mesh=None) -> Callable:
    """→ ``step(data_u8, labels, idx, draws) -> (loss, acc)``, device
    tensors; the step updates ``net`` and ``opt`` in place. ``image_size``
    299 is the notebook's; smaller sides (≥ 75) keep CPU tests small. Over
    ``mesh``, ``idx`` and ``draws`` are the global batch's: the step keeps
    this rank's rows, averages the gradients over the ranks before SGD,
    and returns the global loss and accuracy."""
    normalize = _normalizer(next(net.parameters()).device)

    def step(data_u8: torch.Tensor, labels_all: torch.Tensor, idx: torch.Tensor,
             draws: StepDraws):
        if mesh is not None:
            idx, draws = mesh.rows(idx), shard_step_draws(draws, mesh)
        labels = labels_all[idx].long()
        x01 = data_u8[idx].float() / 255.0
        x = normalize(random_resized_crop_flip(x01, image_size, draws.crops))
        logits = net.forward_train(x.to(compute_dtype), draws.keep, compute_dtype, mesh=mesh)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            mesh.average_grads(net.parameters())
            loss, acc = mesh.mean(loss), mesh.mean(acc)
        opt.step()
        return loss.detach(), acc

    return step


def step_inputs(idx: torch.Tensor, draws: StepDraws) -> dict:
    """A step's inputs as a superstep takes them: the batch's indices and
    its draws, by name."""
    return {"idx": idx, **draws.crops._asdict(), "keep": draws.keep}


def make_superstep(step: Callable, data_u8: torch.Tensor, labels_all: torch.Tensor,
                   graph, mesh=None) -> Superstep:
    """``make_train_step``'s step (over ``mesh``) as a ``Superstep`` on the
    resident set: its inputs ``step_inputs``' (the global batch's), its
    output (loss, acc)."""
    def body(x: dict) -> torch.Tensor:
        draws = StepDraws(CropDraws(*(x[k] for k in CropDraws._fields)), x["keep"])
        return torch.stack(step(data_u8, labels_all, x["idx"], draws))

    return Superstep(body, data_u8.device, graph, mesh)


def make_eval_fn(net: inception_v3.InceptionV3, compute_dtype=torch.bfloat16,
                 image_size: int = 299) -> Callable:
    """→ ``logits(u8)``: /255, bilinear resize to ``image_size`` in f32
    (the notebook's Resize(299)), normalization, the eval forward."""
    normalize = _normalizer(next(net.parameters()).device)

    def logits_fn(u8: torch.Tensor) -> torch.Tensor:
        x = normalize(resize_bilinear(u8.float() / 255.0, image_size))
        return net(x.to(compute_dtype), compute_dtype)

    return logits_fn


def _eval_batch(n: int, batch_size: int, mesh=None) -> int:
    """The eval batch for ``n`` images: at most ``batch_size``, rounded up
    to a multiple of the mesh's data axis (jckx's ``_round_bs``)."""
    size = mesh.size if mesh is not None else 1
    return -(-min(batch_size, n) // size) * size


def eval_device_set(images_u8: np.ndarray, batch_size: int = 256, device=None,
                    mesh=None) -> torch.Tensor:
    """The eval split padded to a batch multiple (the last image
    repeated), uploaded once."""
    n = images_u8.shape[0]
    bs = _eval_batch(n, batch_size, mesh)
    pad = (bs - n % bs) % bs
    imgs = np.concatenate([images_u8, images_u8[-1:].repeat(pad, axis=0)]) if pad else images_u8
    return device_copy(imgs, device)


def evaluate(logits_fn: Callable, device_images: torch.Tensor, labels: np.ndarray,
             batch_size: int = 256, mesh=None) -> dict:
    """top-1 / top-5 / superclass accuracy and mean cross-entropy (the
    notebook's get_eval) of ``eval_device_set``'s upload of the split
    whose labels are ``labels``, computed in numpy as jckx's
    (``:186-229``). Over ``mesh`` each rank takes its rows of every batch
    and the logits are gathered in order."""
    n = len(labels)
    bs = _eval_batch(n, batch_size, mesh)
    with torch.inference_mode():
        batches = [device_images[i:i + bs] for i in range(0, device_images.shape[0], bs)]
        if mesh is None:
            logits = torch.cat([logits_fn(b) for b in batches])
        else:
            logits = torch.cat([mesh.all_gather_rows(logits_fn(mesh.rows(b))) for b in batches])
    logits = logits.float().cpu().numpy()[:n]
    top1 = (logits.argmax(-1) == labels).mean()
    k = min(5, logits.shape[1])
    top5_idx = np.argpartition(logits, -k, axis=1)[:, -k:]
    top5 = (top5_idx == labels[:, None]).any(axis=1).mean()
    sup = (FINE_TO_SUPERCLASS[logits.argmax(-1) % 100] == FINE_TO_SUPERCLASS[labels % 100]).mean()
    lse = logits - logits.max(-1, keepdims=True)
    logp = lse - np.log(np.exp(lse).sum(-1, keepdims=True))
    ce = -logp[np.arange(n), labels].mean()
    return dict(top1=float(top1), top5=float(top5), superclass=float(sup), loss=float(ce))


def _atomic_savez(path: str, arrays: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_npz(path: str, net: inception_v3.InceptionV3) -> None:
    """The weights in jckx's flat ``.npz`` layout, written atomically."""
    _atomic_savez(path, inception_v3.to_jckx_flat(net))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_train_state(path: str, net, opt, generator: torch.Generator, epoch: int,
                     best_acc: float, best_loss: float, patience: int) -> None:
    """Epoch-boundary resume state in one atomic file: the state dict
    (``p::``), SGD's momentum buffers by parameter name (``m::``), the
    loop counters and bests, and the generator's state."""
    state = {f"p::{k}": _host(v) for k, v in net.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    for name, p in net.named_parameters():
        buf = opt.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            state[f"m::{name}"] = _host(buf)
    _atomic_savez(path, dict(meta=np.array([epoch, patience], np.int64),
                             bests=np.array([best_acc, best_loss], np.float64),
                             generator=_host(generator.get_state()), **state))


def load_train_state(path: str, net, opt, generator: torch.Generator):
    """Restore ``save_train_state``'s file into ``net``, ``opt`` and
    ``generator`` (in place). → (epoch, best_acc, best_loss, patience)."""
    with np.load(path) as z:
        sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("p::")}
        missing, unexpected = net.load_state_dict(sd, strict=False)
        if unexpected or [k for k in missing if not k.endswith("num_batches_tracked")]:
            raise ValueError(f"resume state {path} does not match the model: missing {missing}, "
                             f"unexpected {unexpected} (a different class count?)")
        for name, p in net.named_parameters():
            if f"m::{name}" in z.files:
                opt.state[p]["momentum_buffer"] = torch.from_numpy(z[f"m::{name}"]).to(p.device)
        generator.set_state(torch.from_numpy(z["generator"]))
        epoch, patience = (int(v) for v in z["meta"])
        best_acc, best_loss = (float(v) for v in z["bests"])
    return epoch, best_acc, best_loss, patience


@dataclass
class FinetuneRun:
    """The fine-tune's state on the device (``prepare``) and what ``train``
    leaves behind: the net, its optimizer and step, the resident data, the
    draws' generator, the step's graph on the card, the steps of a launch
    that ends in a read, the bests, and one record per epoch run (losses,
    metrics, and the host seconds of its steps, its evals and its ``.npz``
    writes)."""
    net: inception_v3.InceptionV3
    opt: torch.optim.SGD
    step: Callable
    data: torch.Tensor
    labels: torch.Tensor
    generator: torch.Generator
    scan_steps: int = 0  # a launch of this many steps ends in its one host read
    superstep: Optional[Superstep] = None  # the step's graph on the card
    best_acc: float = 0.0
    best_loss: float = 1e10
    start_epoch: int = 0
    epochs: List[dict] = field(default_factory=list)


def _load_splits(args, logger):
    """→ (x, y, xt, yt, num_classes, synthetic) on the host, as jckx's
    ``train`` (``:351-389``)."""
    if args.dataset in ("npz", "folder"):
        x, y, ncls, _, _ = load_dataset(args.dataset, args.data_dir, data_path=args.data_path,
                                        image_size=args.image_size, channels=3)
        if args.valid_data_path:
            xt, yt, ncls_v, _, _ = load_dataset(args.dataset, args.data_dir,
                                                data_path=args.valid_data_path,
                                                image_size=args.image_size, channels=3)
            if ncls_v > ncls:
                raise ValueError(f"valid split has {ncls_v} classes, train has {ncls}")
        else:
            perm = np.random.RandomState(args.seed).permutation(len(x))
            nv = max(1, len(x) // 10)
            xt, yt = x[perm[:nv]], y[perm[:nv]]
            x, y = x[perm[nv:]], y[perm[nv:]]
            logger.info(f"custom data: seeded 10% holdout as the valid split "
                        f"({nv} of {nv + len(x)} images)")
        synthetic = False
    else:
        syn_n = args.synthetic_size
        x, y, ncls, _, synthetic = load_dataset(args.dataset, args.data_dir, train=True,
                                                seed=args.seed, synthetic_n=syn_n)
        xt, yt, _, _, _ = load_dataset(args.dataset, args.data_dir, train=False,
                                       seed=args.seed + 1, synthetic_n=syn_n // 5)
    if synthetic:
        logger.warning("archive not found — fine-tuning on synthetic data")
    if x.shape[-1] == 1:
        x, xt = x.repeat(3, axis=-1), xt.repeat(3, axis=-1)
    return x, y, xt, yt, ncls, synthetic


def prepare(args, x: np.ndarray, y: np.ndarray, num_classes: int, device: torch.device,
            mesh=None, logger=None) -> FinetuneRun:
    """The fine-tune's state on ``device``: the seeded net
    (``inception_v3.init(args.seed)``, ``num_classes`` wide), its nesterov
    SGD and train step (over ``mesh``), the train rows ``x`` (uint8 NHWC)
    and labels ``y`` resident on the device, the draws' generator seeded
    with ``args.seed``, and where ``graph_for`` allows it the step's
    superstep. ``train`` and the benchmark drive it through ``launch``."""
    net = inception_v3.init(args.seed, num_classes=num_classes).to(device)
    opt = make_optimizer(net, args.max_learning_rate, args.weight_decay,
                         nesterov=bool(args.nesterov))
    step = make_train_step(net, opt, _DTYPES[args.compute_dtype], args.image_size, mesh)
    data = device_copy(x, device)
    labels = torch.from_numpy(y.astype(np.int64)).to(device)
    graph, why_eager = graph_for(device, mesh=mesh)
    superstep = make_superstep(step, data, labels, graph, mesh) if graph else None
    if logger is not None:
        logger.debug("train step: " + (
            "one CUDA graph, captured after the run's first (eager) step and replayed"
            + ("; the mesh's collectives inside it" if mesh is not None else "")
            if graph else f"eager, {why_eager}"))
    return FinetuneRun(net, opt, step, data, labels,
                       torch.Generator(device=device).manual_seed(args.seed), args.scan_steps,
                       superstep)


def launch(run: FinetuneRun, order_dev: torch.Tensor, i: int, k: int):
    """Steps ``i`` … ``i + k − 1`` of the epoch whose batches of row indices
    are ``order_dev`` (steps, batch) on the device, as one launch: k eager
    steps, or k replays of the step's graph. Each step's index slice and
    draws come from ``run.generator`` in step order: step 0's first, the
    others' all at once after step 0 is queued, so the card works while
    they are made and none waits behind a queued step. → (rows, read):
    the steps' loss and accuracy, (k, 2) on the device, and where k is
    ``run.scan_steps`` their host copy, the launch's one read, which bounds
    how far the host runs ahead (else None). Under a profiler the launch is
    the span ``finetune.launch`` (n = k), each step's slice and draws
    ``train.feed``, the read ``finetune.telemetry_read``."""
    bs, device = order_dev.shape[1], run.data.device

    def feed(j: int):
        with spans.span("train.feed", 1):
            return order_dev[i + j], draw_step(run.generator, bs, device)

    fed = []

    def inputs(j: int):
        if j == len(fed):  # step 0's alone, then the rest
            fed.extend(feed(m) for m in range(j, k if j else 1))
        return fed[j]

    with spans.span("finetune.launch", k):
        if run.superstep is None:
            rows = torch.stack([torch.stack(run.step(run.data, run.labels, *inputs(j)))
                                for j in range(k)])
        else:
            rows = run.superstep.replay(k, lambda j: step_inputs(*inputs(j)))
        read = None
        if k == run.scan_steps:
            with spans.span("finetune.telemetry_read", k):
                read = rows.cpu().numpy()
    return rows, read


def train(args) -> FinetuneRun:
    device = resolve_device(args.device)
    mesh = process_mesh(args.mesh_shape, multihost=bool(args.multihost), device=device,
                        what="the fine-tune")
    bs = args.batch_size
    if mesh is not None and bs % mesh.size:
        raise ValueError(f"batch_size {bs} not divisible by data axis ({mesh.size})")
    lead = mesh is None or mesh.lead
    if not lead:
        args.log_file = 0  # rank 0 alone writes the log and the files
    if args.log_file == 1 and not args.save_path:
        args.save_path = args.save_dir
    logger = MainLogger(args)
    if mesh is not None:
        logger.debug(f"fine-tune mesh: {mesh.shape} (data-parallel, sync-BN), rank {mesh.rank}")
    x, y, xt, yt, ncls, synthetic = _load_splits(args, logger)
    run = prepare(args, x, y, ncls, device, mesh, logger)
    logits_fn = make_eval_fn(run.net, _DTYPES[args.compute_dtype], args.image_size)
    rng = np.random.RandomState(args.seed)
    steps_per_epoch = len(y) // bs
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)

    yt_eval = yt[: args.eval_samples]
    # one upload for all epochs
    xt_dev = eval_device_set(xt[: args.eval_samples], device=device, mesh=mesh)
    y_eval = x_dev = None
    if args.eval_train:
        y_eval = y[: args.eval_samples]
        x_dev = eval_device_set(x[: args.eval_samples], device=device, mesh=mesh)

    best_acc, best_loss, patience = 0.0, 1e10, 0
    epoch, start_epoch = -1, 0  # sidecar-safe when the epoch budget is 0
    state_path = os.path.join(args.save_dir, "train_state.npz")
    resume = bool(args.resume) and os.path.exists(state_path)
    if mesh is not None:
        resume = mesh.agree(resume, f"--resume: {state_path} exists")
    if resume:
        epoch, best_acc, best_loss, patience = load_train_state(state_path, run.net, run.opt,
                                                                run.generator)
        if run.superstep is not None:  # the momentum buffers are new tensors
            run.superstep.invalidate()
        start_epoch = epoch + 1
        for _ in range(start_epoch):  # fast-forward the shuffle stream
            rng.permutation(len(y))
        logger.debug(f"resumed at epoch {start_epoch} (best top1 {best_acc:.4f}, "
                     f"best loss {best_loss:.4f})")
    run.best_acc, run.best_loss, run.start_epoch = best_acc, best_loss, start_epoch
    per_launch = max(args.scan_steps, 1)
    start = time.time()
    for epoch in range(start_epoch, args.epoch):
        t0 = time.perf_counter()
        order = rng.permutation(len(y))[: steps_per_epoch * bs].reshape(steps_per_epoch, bs)
        order_dev = torch.from_numpy(order).to(device)  # one upload per epoch
        losses, accs = [], []  # device tensors: the host reads them once, after the epoch
        for i in range(0, steps_per_epoch, per_launch):
            k = min(per_launch, steps_per_epoch - i)
            rows, read = launch(run, order_dev, i, k)
            losses += rows[:, 0].unbind()
            accs += rows[:, 1].unbind()
            if read is not None:
                logger.debug(f"epoch {epoch} steps {i}-{i + k - 1}: mean loss "
                             f"{float(read[:, 0].mean()):.4f}")
        tr_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        tr_acc = float(torch.stack(accs).mean()) if accs else float("nan")
        train_s = time.perf_counter() - t0
        if args.nan_guard and losses and not np.isfinite(tr_loss):
            logger.error(f"non-finite train loss at epoch {epoch} — aborting. --resume 1 "
                         f"restarts from the last finished epoch but replays it "
                         f"bit-identically: lower -mlr (or change --seed) when resuming, or "
                         f"--nan_guard 0 to continue anyway")
            raise FloatingPointError(f"training diverged: loss={tr_loss} at epoch {epoch}")

        t0 = time.perf_counter()
        ev = evaluate(logits_fn, xt_dev, yt_eval, mesh=mesh)
        tr_ev = {}
        if x_dev is not None:
            t = evaluate(logits_fn, x_dev, y_eval, mesh=mesh)
            tr_ev = {f"train_eval_{k}": v for k, v in t.items()}
            logger.debug(f"Epoch: {epoch}  train-eval top1 {t['top1']:.4f} top5 {t['top5']:.4f} "
                         f"super {t['superclass']:.4f} loss {t['loss']:.4f}")
        eval_s = time.perf_counter() - t0
        logger.debug(f"Epoch: {epoch}  train loss {tr_loss:.4f} acc {tr_acc:.4f}  valid top1 "
                     f"{ev['top1']:.4f} top5 {ev['top5']:.4f} super {ev['superclass']:.4f} "
                     f"loss {ev['loss']:.4f}")
        logger.scalars({"epoch": epoch, "train_loss": tr_loss, "train_acc": tr_acc, **tr_ev, **ev})

        t0 = time.perf_counter()
        written = []
        improved = False
        if ev["top1"] > best_acc:
            best_acc, improved = ev["top1"], True
            written.append("acc_bset.npz")
        if ev["loss"] < best_loss:
            best_loss, improved = ev["loss"], True
            written.append("loss_bset.npz")
        written.append("last_bset.npz")
        patience = 0 if improved else patience + 1
        if lead:
            for name in written:
                save_npz(os.path.join(args.save_dir, name), run.net)
            save_train_state(state_path, run.net, run.opt, run.generator, epoch, best_acc,
                             best_loss, patience)
        run.epochs.append({"epoch": epoch, "steps": len(losses), "train_loss": tr_loss,
                           "train_acc": tr_acc, **tr_ev, **ev, "train_s": train_s,
                           "eval_s": eval_s, "write_s": time.perf_counter() - t0,
                           "written": written + ["train_state.npz"]})
        if patience >= args.early_stop:
            logger.debug(f"early stopping at epoch {epoch} (patience {args.early_stop})")
            break

    if lead:
        os.makedirs(args.save_dir, exist_ok=True)
        with open(os.path.join(args.save_dir, "summary.json"), "w") as f:
            json.dump({"dataset": args.dataset, "synthetic_fallback": bool(synthetic),
                       "epochs_run": epoch + 1, "epoch_budget": args.epoch, "batch_size": bs,
                       "best_top1": best_acc, "best_loss": best_loss,
                       "wall_s": round(time.time() - start, 1)}, f, indent=2)
    multihost_barrier("fine-tune done", logger)
    logger.debug(f"fine-tune finish\ttime: {time_to_str(time.time() - start)}  "
                 f"best top1 {best_acc:.4f} best loss {best_loss:.4f}")
    run.best_acc, run.best_loss = best_acc, best_loss
    return run


def get_args(argv=None):
    p = argparse.ArgumentParser(description="jckx_torch InceptionV3 fine-tune (metric backbone)")
    p.add_argument("--dataset", default="cifar100",
                   help="cifar100 / cifar10 / mnist / synthetic, or npz / folder with --data_path")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--data_path", default="",
                   help="custom data: the .npz file (npz) or the image directory (folder)")
    p.add_argument("--valid_data_path", default="",
                   help="custom valid split; absent = seeded 10%% holdout from --data_path")
    p.add_argument("-b", "--batch_size", type=int, default=128)
    p.add_argument("-e", "--epoch", type=int, default=300)
    p.add_argument("-mlr", "--max_learning_rate", type=float, default=0.1)
    p.add_argument("-wd", "--weight_decay", type=float, default=5e-4)
    p.add_argument("-snt", "--nesterov", type=int, default=1, help="nesterov SGD 0/1")
    p.add_argument("--early_stop", type=int, default=10)
    p.add_argument("--resume", type=int, default=0,
                   help="1 = continue from save_dir's train_state.npz")
    p.add_argument("--nan_guard", type=int, default=1,
                   help="abort on non-finite epoch loss (0 = continue)")
    p.add_argument("--scan_steps", type=int, default=0,
                   help="K steps per launch (K replays of the step's graph on the card), their "
                        "mean loss read and logged at its end (0 = one step per launch, the loss "
                        "read once per epoch); the draws come from the same generator either way, "
                        "so it changes no result")
    p.add_argument("--eval_samples", type=int, default=10000)
    p.add_argument("--eval_train", type=int, default=0,
                   help="1 = also run the eval pass on the train split each epoch")
    p.add_argument("--mesh_shape", type=str, default="",
                   help="N = train on N ranks of a process group, one per GPU (torchrun "
                        "--nproc_per_node N); '' = one process (or the whole group under one)")
    p.add_argument("--multihost", type=int, default=0,
                   help="1 = bring the process group up from torch's env:// variables")
    p.add_argument("--image_size", type=int, default=299,
                   help="network input side (299 = notebook parity; >= 75)")
    p.add_argument("--max_steps_per_epoch", type=int, default=0,
                   help="cap steps per epoch (0 = full epoch)")
    p.add_argument("--synthetic_size", type=int, default=0,
                   help="synthetic-fallback train-set size (0 = 4096), test split N/5")
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--save_dir", default="./save/iception_v3")  # the reference's (sic) dirname
    p.add_argument("--save_path", default="")  # logger compat
    p.add_argument("--log_file", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    args = p.parse_args(argv)
    shape = parse_mesh_shape(args.mesh_shape)
    if shape is not None and len(shape) != 1:
        raise SystemExit(f"jckx_torch finetune: --mesh_shape is 1-D (the batch shards over one "
                         f"'data' axis); got {args.mesh_shape!r}")
    return args


def main(argv=None) -> int:
    train(get_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
