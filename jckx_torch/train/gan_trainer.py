"""The DCGAN and CGAN trainers — port of ``_BaseGANTrainer``,
``DCGANTrainer`` and ``CGANTrainer`` (``jckx/train/gan_trainer.py``;
reference train/dcgan_trainer.py:34-239, train/cgan_trainer.py:34-270).

One host loop over launches of train steps (``train/steps.py``). jckx runs
K steps per device launch, each step one compiled program, with
``lax.scan`` (``:279-322``, ``:681-691``). On the card the port runs each
step as the replay of a CUDA graph captured once (``train/superstep.py``):
the run's first step, and the first after a restore, is the eager step,
then the step is captured, and a launch of k steps is k replays. The
resident plane's indices and the streamed slab's rows are copied into the
graph's inputs, with the draws of (seed, step) and a cosine schedule's lr
made on the host before each replay. Over a NCCL process mesh whose model
axis is 1 the step's collectives are nodes of the graph, and the feed
draws the global batch and keeps this rank's rows, as the eager step does.
The step stays eager on the CPU, under ``--sanitize``, over gloo and with a
model axis (the log says which). Steps go in
launches of ``K = min(log_every, eval_every, steps_per_epoch)``
(``:516-517``), the six scalars of a launch come to the host once, at its
end, and the checks and logs of jckx run there:

- the data order of each epoch is ``np.random.RandomState(seed)``'s
  permutation (``:513,659-661``), so both packages see the same batches;
- the data plane is chosen as jckx chooses it (``:106-134``): resident (the
  uint8 set on the device, each batch gathered there by index), or
  streaming with ``--data_placement stream`` or, under ``auto``, a set
  larger than ``--hbm_data_budget``. Streaming keeps the set on the host;
  each launch of k steps takes one slab of its k·bs rows in the epoch's
  order, gathered by ``-w`` C++ threads into a pinned host buffer and
  copied on a side stream (``data/pipeline.py``), by a single uploader
  thread that prepares slab N+1 while the card runs launch N: at most two
  slabs are on the device. Both planes hand each step the same uint8
  rows, so they train identically. SIGTERM and the nan-guard abort shut the
  uploader down (its queued slab dropped, a running one joined) before the
  gather threads close; an uploader's error reaches the train thread;
- ``nan_guard`` aborts on non-finite telemetry, rolling back to
  ``latest.ckpt`` (a restore rebinds the optimizers' state, so the graph is
  recaptured, as after ``--resume`` or ``--init_from_torch``); SIGTERM
  (``preempt_save``) saves ``latest.ckpt`` at the
  next launch boundary and returns with ``preempted`` set (the entry
  point exits 143);
- evals fall on launch boundaries (``:779-783``): after the first launch,
  whenever a launch crosses a multiple of ``eval_every``, and after the
  last step. An eval samples the fixed eval inputs (drawn from the seed,
  ``fixed_eval_inputs``) under ``torch.no_grad()``, which on the card is
  where the fused BN kernel runs: 4 launches per G forward at 64². DCGAN
  renders its ``sample_count`` z in one batch; CGAN renders 10 z per
  class, class-major, in chunks of 500 (``:913-923``): under batch-stat
  BN the chunking is part of the function, so 2 forwards at K = 100.
  On the card each forward is a replay of one CUDA graph per forward
  shape (``eval_program``; eager where the step is; over a mesh the graph
  holds the rank's rows, G's sync-BN and the ordered gather), rebuilt
  after a restore. Then FID / IS (and CGAN's intra-FID), best-metric checkpoints
  and grids, and ``latest.ckpt``;
- ``--resume`` restores ``latest.ckpt`` and fast-forwards the shuffle
  stream; the step's draws derive from (seed, step), so the resumed run
  continues as the uninterrupted one would. A ``latest.ckpt`` written by
  jckx resumes too (``checkpoint.load_checkpoint``); its draws then come
  from the port's generators, not from jckx's rng, and the log says so.

The artifacts are jckx's: ``real_image.png``, ``<metric>/<iters>_fake_image
.png``, CGAN's labelled class panel ``img/<iters>_fake_image.png``,
``loss.png``, ``metrics.jsonl`` and the run log.

Data parallel over a process mesh (``mesh``; jckx ``:73-102``): every rank
runs this trainer on the same seeded permutation and keeps its rows of
each global batch. The resident plane holds the whole uint8 set on every
rank, as jckx replicates ``images_dev``, and gathers only the rank's rows;
the streaming plane's slabs hold only the rank's rows of each launch
(jckx: each process uploads its addressable shards). The steps average
gradients and telemetry over the ranks (``train/steps.py``), so every rank
sees the same metrics and takes the same decisions (the nan-guard, the
evals). An eval renders each rank's share of the fixed inputs with global
BN statistics, through the kernel, and gathers them in order; the metrics
engine extracts its features data-parallel. Rank 0 alone writes files:
logs, ``metrics.jsonl``, grids, checkpoints, the real-feature cache
(jckx's ``_lead``).

With a model axis (``--mesh_shape D,M --mesh_axes data,model``) the M
ranks of a model group hold the same rows and draws, and the state and the
step are laid out by ``--model_axis_mode`` (``train/state.py``,
``train/steps.py``, ``parallel/``). Under TP each eval gathers G's (or the
EMA's) shards once and renders over the data axis through the kernel;
under ``spatial`` the eval renders as above. Checkpoints hold full tensors
(every rank gathers, rank 0 writes), and ``--resume`` / ``--init_from_torch``
slice them for this run's layout. ``--resume`` reads on every rank. SIGTERM keeps jckx's
contract (the scheduler signals every rank); the ranks agree at each
launch boundary on whether any was signalled, so they stop together.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import weakref
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from jckx_torch.checkpoint.checkpoint import (BestMetricCheckpointer, latest_checkpoint,
                                              restore_checkpoint, state_payload)
from jckx_torch.configs import Config
from jckx_torch.data import native_io
from jckx_torch.data.pipeline import (HostStreamLoader, PinnedSlabs, decode_batch, device_copy,
                                      one_hot)
from jckx_torch.kernels import fused_bn_act
from jckx_torch.logging.artifacts import save_image_grid, save_labeled_grid, save_loss_curve
from jckx_torch.logging.main_logger import MainLogger, time_to_str
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.parallel import tp
from jckx_torch.train.state import create_dcgan_state, geometry, schedule_lr
from jckx_torch.train.steps import (METRIC_NAMES, StepDraws, compute_dtype, derive_seed,
                                    make_cgan_train_step, make_dcgan_train_step, rank_draws)
from jckx_torch.train.superstep import Superstep
from jckx_torch.utils import spans
from jckx_torch.utils.device import resolve_device
from jckx_torch.utils.graphs import GraphedProgram, graph_for

EVAL_CHUNK = 500  # CGAN eval rows per G forward (jckx gan_trainer.py:919)


def fixed_eval_inputs(seed: int, geo: GANGeometry, conditional: bool, num_classes: int,
                      sample_count: int, device: torch.device, truncation: float = 0.0):
    """The trainers' eval inputs, drawn on ``device`` from the generator of
    (seed, "eval"): ``sample_count`` z for DCGAN (one-hot None); 10 z per
    class and the class-major one-hot labels for CGAN (``:463-480``).
    ``truncation`` t > 0 draws z from N(0, 1) truncated to [-t, t] instead
    (``evaluate --truncation``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "eval", 0))
    rows = 10 * num_classes if conditional else sample_count
    if truncation > 0:
        z = torch.nn.init.trunc_normal_(torch.empty((rows, geo.z_dim), device=device), 0.0, 1.0,
                                        -truncation, truncation, generator=gen)
    else:
        z = torch.randn((rows, geo.z_dim), generator=gen, device=device)
    if not conditional:
        return z, None
    labels = torch.arange(num_classes, device=device).repeat_interleave(10)
    return z, one_hot(labels, num_classes)


def _forward(G, cd, mesh=None):
    """One eval forward of G on a forward's inputs (``G(z, cd)``, or ``G(z,
    onehot, cd)`` for CGAN). Over ``mesh`` each rank renders its rows with
    the global statistics, and the rows are gathered in order."""
    def forward(zz, oh):
        if mesh is None:
            return G(zz, cd) if oh is None else G(zz, oh, cd)
        zz, oh = mesh.rows(zz), None if oh is None else mesh.rows(oh)
        out = G(zz, cd, mesh=mesh) if oh is None else G(zz, oh, cd, mesh=mesh)
        return mesh.all_gather_rows(out)

    return forward


def eval_program(G, cd, device: torch.device, graph: Optional[type],
                 mesh=None) -> Optional[GraphedProgram]:
    """G's eval forward (``_forward``) as a graphed program, one graph per
    forward shape (jckx jits its eval sampler, ``jckx/train/gan_trainer.py:
    337``, ``jckx/evaluate.py:203-211``); over ``mesh`` the graph holds
    the rank's rows, the statistics' all-reduces and the gather. None where
    ``graph`` is (``graph_for``: the CPU, a mesh that stays eager,
    ``--sanitize``). The program holds this G: whatever rebinds its
    tensors needs a new program."""
    if graph is None:
        return None
    return GraphedProgram(_forward(G, cd, mesh), device, graph, mesh)


def sample_eval_images(G, z: torch.Tensor, onehot: Optional[torch.Tensor], cd,
                       mesh=None, program: Optional[GraphedProgram] = None) -> torch.Tensor:
    """G on the eval inputs with no grad (on the card, through the fused BN
    kernel): one forward for DCGAN, chunks of ``EVAL_CHUNK`` for CGAN (a
    shorter last chunk is another shape). ``program`` (``eval_program`` of
    this G over this mesh) replays each forward as a graph. Over ``mesh``
    each rank renders its rows of every forward with the global
    statistics, and the rows are gathered in order."""
    forward = program if program is not None else _forward(G, cd, mesh)

    with torch.no_grad():
        if onehot is None:
            return forward(z, None)
        return torch.cat([forward(z[i:i + EVAL_CHUNK], onehot[i:i + EVAL_CHUNK])
                          for i in range(0, z.shape[0], EVAL_CHUNK)])


class _BaseGANTrainer:
    """``Trainer(cfg, G, D, data_pre, metrics=None, mesh=None).train()``;
    ``metrics`` replaces the InceptionV3 engine (the tests pass a stub),
    ``mesh`` is the process mesh of a data-parallel run."""

    conditional = False

    def __init__(self, cfg: Config, G, D, data_pre, metrics=None, mesh=None):
        self.mesh = mesh
        self.lead = mesh is None or mesh.lead
        if mesh is not None and cfg.batch_size % mesh.size:
            raise ValueError(
                f"global batch_size {cfg.batch_size} is not divisible by the mesh 'data' axis "
                f"({mesh.size} shards): pick a multiple of {mesh.size}")
        self.local_bs = cfg.batch_size // (mesh.size if mesh is not None else 1)
        if not cfg.save_path:
            ts = cfg.model_path or datetime.now().strftime("%Y%m%d_%H%M%S")
            cfg.save_path = os.path.join(cfg.save_root, "cgan" if self.conditional else "dcgan", ts)
        if self.lead:
            os.makedirs(cfg.save_path, exist_ok=True)
        else:
            cfg.log_file = 0  # rank 0 alone writes the log and metrics.jsonl
        self.logger = MainLogger(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.geo = geometry(cfg)
        self.cd = compute_dtype(cfg)
        self.data_pre = data_pre
        self.num_classes = data_pre.num_classes
        self.n_data = data_pre.images_u8.shape[0]
        nbytes = data_pre.images_u8.nbytes
        self._streaming = cfg.data_placement == "stream" or (
            cfg.data_placement == "auto" and nbytes > cfg.hbm_data_budget)
        self.images_dev = self.labels_dev = None
        if self._streaming:
            self._stream = HostStreamLoader(data_pre.images_u8, data_pre.labels_np,
                                            workers=cfg.num_worker)
            self.logger.debug(
                f"data plane: host-streaming ({nbytes / 2**30:.2f} GiB, {self._stream.workers} "
                f"gather workers, {native_io.engine()} gather)")
        else:
            # the uint8 set (and CGAN's int64 labels) on the device, one copy
            self.images_dev = device_copy(data_pre.images_u8, self.device)
            if self.conditional:
                self.labels_dev = device_copy(np.asarray(data_pre.labels_np, np.int64), self.device)
            self.logger.debug(
                f"data plane: resident on {self.device} ({nbytes / 2**30:.2f} GiB)"
                + (" — -w/--num_worker has no role (no host loader; use --data_placement "
                   "stream to engage it)" if cfg.num_worker else ""))
        self.logger.debug(
            f"G params: {sum(p.numel() for p in G.parameters()):,}  D params: "
            f"{sum(p.numel() for p in D.parameters()):,}  device: {self.device}  "
            f"mesh: {mesh.shape if mesh is not None else {'data': 1}}"
            + (f" ({cfg.model_axis_mode})" if mesh is not None and mesh.model_size > 1 else "")
            + "  "
            f"compute: {cfg.compute_dtype}")

        self.metric = metrics
        if self.metric is None and cfg.eval_every > 0:
            from jckx_torch.metrics.metrics import Metrics

            self.metric = Metrics(data_pre.metric_source, cfg, batch_size=cfg.eval_batch_size,
                                  compute_dtype=self.cd, cache_dir=cfg.data_dir,
                                  num_classes=self.num_classes, device=self.device, mesh=mesh)

        if cfg.lr_schedule != "constant" and cfg.lr_decay_steps <= 0:
            # the horizon describes the run, so a resume keeps decaying
            cfg.lr_decay_steps = max(1, (self.n_data // cfg.batch_size) * cfg.epoch)
            self.logger.debug(f"lr_schedule={cfg.lr_schedule}: decay horizon auto-set to "
                              f"{cfg.lr_decay_steps} steps ({cfg.epoch} epochs)")
        self.state = create_dcgan_state(cfg, G.to(self.device), D.to(self.device), mesh)
        self.save_path = cfg.save_path
        self.ckpt = BestMetricCheckpointer(self.save_path)
        self.bests = {"fid": 1e10, "is": 0.0, "intra_fid": 1e10}
        self._resumed_losses: list = []
        self._poisoned: Optional[str] = None
        self._preempt = threading.Event()
        self.preempted = False
        self.evals: list = []  # the iterations evaluated, in order
        graph, why_eager = graph_for(self.device, cfg.sanitize, mesh)
        # the body holds the trainer weakly: a dropped trainer frees its
        # graph's memory at once, not at the next cyclic collection
        body = weakref.WeakMethod(self._graph_body)
        self.superstep = (Superstep(lambda x: body()(x), self.device, graph, mesh) if graph
                          else None)
        self._eval_graph = graph
        self.eval_program = self._eval_program()
        self.logger.debug("train step: " + (
            "one CUDA graph, captured after the run's first (eager) step and replayed; the eval "
            "sampler one graph per forward shape"
            + ("; the mesh's collectives inside them" if mesh is not None else "")
            if graph else f"eager, {why_eager}"))
        if cfg.init_from_torch:
            self._restore(cfg.init_from_torch)
            self.logger.info(f"warm-started from torch checkpoint {cfg.init_from_torch} "
                             f"at step {self.state.step}")
        if cfg.resume:  # a latest.ckpt in the run dir wins over --init_from_torch
            path = latest_checkpoint(self.save_path)
            if mesh is not None:
                mesh.agree(path is not None, f"--resume: {self.save_path}/latest.ckpt exists")
            if path is None:
                self.logger.debug("resume requested but no latest.ckpt found")
            else:
                self._restore(path)
                self.logger.debug(f"resumed from {path} at step {self.state.step}")
        make_step = make_cgan_train_step if self.conditional else make_dcgan_train_step
        self.step_fn = make_step(cfg, self.geo, mesh)
        self.eval_z, self.eval_onehot = fixed_eval_inputs(
            cfg.seed, self.geo, self.conditional, self.num_classes, cfg.sample_count, self.device)
        rows = self.eval_z.shape[0]
        forwards = ([min(EVAL_CHUNK, rows - i) for i in range(0, rows, EVAL_CHUNK)]
                    if self.conditional else [rows])
        if mesh is not None and cfg.eval_every > 0 and any(f % mesh.size for f in forwards):
            raise ValueError(f"the eval's G forwards of {forwards} rows do not split over the "
                             f"mesh's {mesh.size} ranks (--sample_count, or the class count)")

    # ------------------------------------------------------------ restore

    def _restore(self, path: str) -> None:
        extra = restore_checkpoint(path, self.state, self.cfg.max_learning_rate)
        self.bests.update(extra.get("bests", {}))
        self._resumed_losses = [tuple(p) for p in extra.get("losses", [])]
        if self.superstep is not None:  # the optimizers' state and the EMA are new tensors
            self.superstep.invalidate()
        if self.eval_program is not None:  # a program for the restored EMA (or G)
            self.eval_program = self._eval_program()
        if "jckx_rng" in extra:
            self.logger.warning(
                f"{path} was written by jckx: its weights, Adam state and step carry over; "
                f"the step's draws continue from this port's generators of (seed "
                f"{self.state.seed}, step), not from jckx's rng {extra['jckx_rng']}")

    def _rollback_after_divergence(self, step_hint: int) -> None:
        """Restore ``latest.ckpt`` after a nan-guard abort, so that a caller
        who catches the error and trains again continues from good state;
        without one, refuse to train again."""
        path = latest_checkpoint(self.save_path)
        if path is None:
            self._poisoned = (f"training diverged by step {step_hint} with no latest.ckpt "
                              "to roll back to — rebuild the trainer instead of calling "
                              "train() again")
            return
        self._restore(path)
        self.logger.warning(f"rolled back to {path} (step {self.state.step}) after divergence")

    def _serve_config(self) -> dict:
        g = self.geo
        return {"conditional": self.conditional, "num_classes": self.num_classes,
                "z_dim": g.z_dim, "image_size": g.image_size, "channels": g.channels,
                "base_width": g.base_width, "ema": self.cfg.ema_decay > 0}

    # --------------------------------------------------------------- train

    def train(self):
        if self._poisoned:
            raise RuntimeError(self._poisoned)
        cfg = self.cfg
        bs, lb = cfg.batch_size, self.local_bs
        spe = self.n_data // bs
        lo = (self.mesh.rank if self.mesh is not None else 0) * lb  # this rank's rows
        if spe == 0:
            raise ValueError(f"batch_size {bs} exceeds the dataset ({self.n_data} rows): "
                             f"0 steps/epoch — nothing would train")
        rng = np.random.RandomState(cfg.seed)
        log_k = cfg.log_every if cfg.log_every > 0 else spe
        K = max(1, min(log_k, cfg.eval_every if cfg.eval_every > 0 else log_k, spe))
        losses_d = [p[0] for p in self._resumed_losses]
        losses_g = [p[1] for p in self._resumed_losses]
        if self.lead:
            save_image_grid(os.path.join(self.save_path, "real_image.png"),
                            self.data_pre.images_u8[:64], ncol=8, padding=5)

        start = time.perf_counter()
        self.logger.debug("train start")
        it = self.state.step
        self.logger.scalars({"event": "session_start", "step": it})
        last_metrics = None
        # resume: restart at the completed epochs, advance the shuffle
        # stream as far, and continue inside a mid-epoch checkpoint's epoch
        start_epoch = min(it // spe, cfg.epoch)
        resume_offset = it - start_epoch * spe
        if it > 0 and it >= cfg.epoch * spe:
            self.logger.warning(
                f"resumed step {it} >= total steps for this config ({cfg.epoch} epochs x "
                f"{spe} steps/epoch = {cfg.epoch * spe}) - nothing left to train; if the run "
                f"is not actually complete, check that --epoch and the dataset size match")
        for _ in range(start_epoch):
            rng.permutation(self.n_data)

        self._preempt.clear()
        self.preempted = False
        prev_term = None
        rolled_back = False
        own_handler = cfg.preempt_save and threading.current_thread() is threading.main_thread()
        uploader = None
        try:
            if own_handler:
                prev_term = signal.signal(signal.SIGTERM, lambda signum, frame: self._preempt.set())
            if self._streaming:
                from concurrent.futures import ThreadPoolExecutor

                # one uploader thread: slab N+1 is gathered and copied while
                # the card runs launch N (jckx gan_trainer.py:566-580)
                uploader = ThreadPoolExecutor(1, thread_name_prefix="jckx-upload")
                slabs = PinnedSlabs(self.device, [(self.data_pre.images_u8.shape[1:], torch.uint8),
                                                  ((), torch.int64)], K * lb)

                def _upload(rows: np.ndarray):
                    u8, labels = slabs.fill(len(rows))
                    labels[:] = self._stream.take(rows, out=u8)[1]
                    return slabs.upload(len(rows))

                def _submit(first: int):
                    return uploader.submit(_upload, order[first:first + min(K, spe - first)].ravel())
            for epoch in range(start_epoch, cfg.epoch):
                # every rank draws the same permutation and keeps its rows of each batch
                order = rng.permutation(self.n_data)[: spe * bs].reshape(spe, bs)[:, lo:lo + lb]
                done, resume_offset = resume_offset, 0
                upload_next = _submit(done) if self._streaming and done < spe else None
                while done < spe:
                    k = min(K, spe - done)
                    t_launch = time.perf_counter()
                    if self._streaming:
                        with spans.span("train.upload_wait", k):
                            slab, upload_next = upload_next.result(), None
                        if done + k < spe:
                            upload_next = _submit(done + k)
                        u8, labels = slabs.use(slab)
                        batches = [{"u8": u8[j * lb:(j + 1) * lb],
                                    **({"labels": labels[j * lb:(j + 1) * lb]}
                                       if self.conditional else {})} for j in range(k)]
                        del slab, u8, labels
                    else:
                        idx = torch.from_numpy(order[done:done + k].astype(np.int64)).to(self.device)
                        batches = [{"idx": idx[j]} for j in range(k)]
                    vals = self._launch(batches)
                    del batches  # this slab's memory goes back once its steps have run
                    with spans.span("train.telemetry_read", k):
                        vals = vals.cpu().numpy()  # (k, 6): the launch's one sync
                    ms_np = {n: vals[:, i] for i, n in enumerate(METRIC_NAMES)}
                    launch_dt = time.perf_counter() - t_launch
                    if cfg.nan_guard:
                        bad = [n for n, v in ms_np.items() if not np.isfinite(v).all()]
                        if bad:
                            self.logger.error(
                                f"non-finite training metrics {bad} in steps {it}..{it + k} — "
                                f"aborting (resume from latest.ckpt; --nan_guard 0 to continue)")
                            rolled_back = True
                            self._rollback_after_divergence(it + k)
                            raise FloatingPointError(
                                f"training diverged: non-finite {bad} by step {it + k}")
                    last_metrics = {n: float(v[-1]) for n, v in ms_np.items()}
                    losses_d += ms_np["loss_d"].tolist()
                    losses_g += ms_np["loss_g"].tolist()
                    for s_off in range(k):
                        step_i = done + s_off
                        if cfg.log_every > 0 and step_i % cfg.log_every == 0:
                            self.logger.debug(
                                f"[{epoch}/{cfg.epoch}][{step_i}/{spe}]\t"
                                f"loss_d: {ms_np['loss_d'][s_off]:.4f}\t"
                                f"loss_g: {ms_np['loss_g'][s_off]:.4f}\t"
                                f"D(x): {ms_np['d_x'][s_off]:.4f}\t"
                                f"D(G(z)): {ms_np['d_gz1'][s_off]:.4f} / {ms_np['d_gz2'][s_off]:.4f}")
                    self.logger.scalars({
                        "step": it + k, "epoch": epoch,
                        "images_per_sec": round(bs * k / max(launch_dt, 1e-9), 1),
                        "step_ms": round(1e3 * launch_dt / k, 3), **last_metrics})

                    prev_it = it
                    it += k
                    done += k
                    last_step_of_run = epoch == cfg.epoch - 1 and done >= spe
                    stop = self._preempt.is_set()
                    if self.mesh is not None:
                        stop = self.mesh.any(stop)  # the ranks stop at the same boundary
                    if stop:
                        self.preempted = True
                        self.logger.warning(f"SIGTERM received — saving latest.ckpt at step {it} "
                                            f"and exiting (continue with --resume)")
                        payload = state_payload(self.state, {  # every rank: TP gathers
                            "bests": dict(self.bests), "losses": list(zip(losses_d, losses_g)),
                            "serve_config": self._serve_config()})
                        if self.lead:
                            self.ckpt.save_latest(payload)
                        if not last_step_of_run:
                            break
                        # the signal landed in the run's last launch: its
                        # final eval still runs (latest.ckpt is already safe)
                    if cfg.eval_every > 0 and (
                            prev_it // cfg.eval_every != it // cfg.eval_every or prev_it == 0
                            or last_step_of_run):
                        self._evaluate(it, losses_d, losses_g)
                if self.preempted:
                    break
        finally:
            if own_handler:
                signal.signal(signal.SIGTERM, prev_term if prev_term is not None else signal.SIG_DFL)
            if uploader is not None:
                # a queued upload is dropped and a running one joined before
                # the gather threads close: its take() would otherwise race
                # the close and start a pool nothing shuts down
                uploader.shutdown(wait=True, cancel_futures=True)
                self._stream.close()
            if not rolled_back:  # a second train() continues this history
                self._resumed_losses = list(zip(losses_d, losses_g))
        self.logger.debug(f"train finish\ttime: {time_to_str(time.perf_counter() - start)}\t"
                          f"fused BN kernel launches in this process: {fused_bn_act.LAUNCHES}, "
                          f"moments kernels: {fused_bn_act.MOMENTS_LAUNCHES}")
        if self.lead:
            save_loss_curve(os.path.join(self.save_path, "loss.png"), losses_d, losses_g)
        return last_metrics

    # --------------------------------------------------------------- steps

    def _launch(self, batches: list) -> torch.Tensor:
        """One launch: a step on each entry of ``batches``, its data inputs
        (``{"idx": ...}`` on the resident plane, ``{"u8": ..., "labels":
        ...}`` streamed) → the (k, 6) telemetry on the device. Through the
        superstep when there is one, else one eager ``_train_step`` each;
        the superstep's eager step before a capture is ``_train_step`` too
        (its own draws and lr are the feed's, made again). Under a profiler
        the launch is the span ``train.launch`` (up to its last step's
        enqueue), each step's host part ``train.feed``."""
        def eager(x):
            m = self._train_step(*self._batch(x))
            return torch.stack([m[n] for n in METRIC_NAMES])

        if self.superstep is None:
            with spans.span("train.launch", len(batches)):
                return torch.stack([eager(x) for x in batches])
        s0 = self.state.step

        def feed(j: int) -> dict:
            # the host's part of step s0 + j: its lr and draws, which a capture would freeze
            with spans.span("train.feed", 1):
                self.state.step = s0 + j
                schedule_lr(self.cfg, self.state)
                draws = rank_draws(self.state.seed, self.state.step, self.local_bs, self.geo,
                                   self.device, self.mesh, self.conditional)
                return {**batches[j], **{k: v for k, v in vars(draws).items() if v is not None}}

        with spans.span("train.launch", len(batches)):
            rows = self.superstep.replay(len(batches), feed, warm=eager)
        self.state.step = s0 + len(batches)
        return rows

    def _graph_body(self, x: dict) -> torch.Tensor:
        """The step the superstep captures: ``_train_step`` on its inputs'
        rows, with their draws, and no lr or count (the feed's)."""
        u8, labels = self._batch(x)
        real = decode_batch(u8, self.cfg.image_size, self.cd)
        draws = StepDraws(**{k: x.get(k) for k in StepDraws.__dataclass_fields__})
        extra = (one_hot(labels, self.num_classes),) if self.conditional else ()
        m = self.step_fn.body(self.state, real, *extra, draws)
        return torch.stack([m[n] for n in METRIC_NAMES])

    def _batch(self, x: dict):
        """A step's uint8 rows and labels (None for DCGAN) from its inputs."""
        if "idx" in x:
            return self._resident_batch(x["idx"])
        return x["u8"], x.get("labels")

    def _resident_batch(self, rows: torch.Tensor):
        """The resident set's uint8 rows ``rows`` (a device index) and their
        labels (None for DCGAN)."""
        labels = self.labels_dev.index_select(0, rows) if self.conditional else None
        return self.images_dev.index_select(0, rows), labels

    def _train_step(self, u8: torch.Tensor, labels: Optional[torch.Tensor]):
        """One eager train step on a uint8 NHWC batch on the device and its
        class labels (unused by DCGAN); both data planes call it."""
        real = decode_batch(u8, self.cfg.image_size, self.cd)
        if self.conditional:
            return self.step_fn(self.state, real, one_hot(labels, self.num_classes))
        return self.step_fn(self.state, real)

    # ---------------------------------------------------------------- eval

    def _eval_G(self):
        return self.state.ema_g if self.state.ema_g is not None else self.state.G

    def _eval_program(self) -> Optional[GraphedProgram]:
        """The eval sampler's program for the current EMA (or G): Adam and
        the EMA update their tensors in place, so it stays valid across
        training; a restore, which binds new ones, builds another."""
        return eval_program(self._eval_G(), self.cd, self.device, self._eval_graph, self.mesh)

    def sample_eval(self) -> torch.Tensor:
        """The fixed eval inputs through the EMA generator when on, else G
        (``sample_eval_images``), each forward a replay of ``eval_program``
        on the card (``eval_program = None`` forces the eager route). Under
        TP its shards are all-gathered once first, as jckx's
        ``_eval_params_g`` reshards to replicated (``:450-461``); the render
        then runs over the data axis."""
        G = self._eval_G()
        if getattr(G, "tp_dims", None) is not None:
            G = tp.gathered(G, self.mesh)
        return sample_eval_images(G, self.eval_z, self.eval_onehot, self.cd, self.mesh,
                                  self.eval_program)

    def _extra_metrics(self, feats) -> dict:
        """KID and precision / recall / density / coverage from the eval's
        own extraction, with ``--extra_metrics 1`` (``jckx/train/
        gan_trainer.py:485-496``): logged scalars only; the best-metric
        checkpoints stay FID / IS / intra-FID."""
        if not self.cfg.extra_metrics:
            return {}
        kid_mean, kid_std = self.metric.kid(features=feats)
        return {"kid": kid_mean, "kid_std": kid_std, **self.metric.prdc(features=feats)}

    def _save_best(self, typ: str, iters: int, values, images, base: dict) -> None:
        """The best-metric checkpoint of ``typ`` (its name carries
        ``values``) and its grid of ``images``; rank 0 only."""
        if not self.lead:
            return
        self.ckpt.save(typ, iters, values, {
            **base, "bests": dict(self.bests), "iters": iters,
            "serve_config": self._serve_config()})
        save_image_grid(os.path.join(self.save_path, typ, f"{iters}_fake_image.png"), images, ncol=8)
        self.logger.debug(f"{iters} model save ({typ})")

    def _save_latest(self, base: dict, losses_d, losses_g) -> None:
        if self.lead:
            self.ckpt.save_latest({**base, "bests": dict(self.bests),
                                   "losses": list(zip(losses_d, losses_g)),
                                   "serve_config": self._serve_config()})


class DCGANTrainer(_BaseGANTrainer):
    """Unconditional trainer (reference train/dcgan_trainer.py)."""

    def _evaluate(self, iters: int, losses_d, losses_g) -> None:
        self.evals.append(iters)
        fake = self.sample_eval()
        feats = self.metric.extract_features(fake)
        is_score = self.metric.inception_score(logits=feats)
        fid = self.metric.fid(features=feats)
        self.logger.debug(f"inception score: {is_score}\tfid: {fid}")
        self.logger.scalars({"step": iters, "fid": fid, "is": is_score,
                             **self._extra_metrics(feats)})
        denorm = 0.5 * fake.float().cpu().numpy() + 0.5
        base = state_payload(self.state)  # one host copy serves every save of this eval
        for typ, value, better in (("fid", fid, fid < self.bests["fid"]),
                                   ("is", is_score, is_score > self.bests["is"])):
            if better:
                self.bests[typ] = value
                self.logger.debug(f"{iters} {'lowest' if typ == 'fid' else 'highest'} {typ}")
                self._save_best(typ, iters, (value,), denorm, base)
        self._save_latest(base, losses_d, losses_g)


class CGANTrainer(_BaseGANTrainer):
    """Conditional trainer (reference train/cgan_trainer.py): intra-FID
    beside FID / IS, a best checkpoint for each, whose file names carry
    (IS, FID, intra-FID), and the labelled per-class panel at every eval."""

    conditional = True

    def _evaluate(self, iters: int, losses_d, losses_g) -> None:
        self.evals.append(iters)
        fake = self.sample_eval()
        feats = self.metric.extract_features(fake)
        is_score = self.metric.inception_score(logits=feats)
        fid = self.metric.fid(features=feats)
        intra = self.metric.intra_fid(features=feats)
        self.logger.debug(f"inception score: {is_score}\tfid: {fid}\tintra fid: {intra}")
        self.logger.scalars({"step": iters, "fid": fid, "is": is_score, "intra_fid": intra,
                             **self._extra_metrics(feats)})
        # one sample per class (cgan_trainer.py:243)
        per_class = 0.5 * fake[::10].float().cpu().numpy() + 0.5
        values = (is_score, fid, intra)
        base = state_payload(self.state)
        for typ, value, better in (("fid", fid, fid < self.bests["fid"]),
                                   ("intra_fid", intra, intra < self.bests["intra_fid"]),
                                   ("is", is_score, is_score > self.bests["is"])):
            if better:
                self.bests[typ] = value
                self.logger.debug(f"{iters} {'highest' if typ == 'is' else 'lowest'} {typ}")
                self._save_best(typ, iters, values, per_class, base)
        if self.lead:
            names = [self.data_pre.idx_to_labels[i] for i in range(self.num_classes)]
            save_labeled_grid(os.path.join(self.save_path, "img", f"{iters}_fake_image.png"),
                              per_class[:100], names[:100])
        self._save_latest(base, losses_d, losses_g)
