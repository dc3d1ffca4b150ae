"""The data axis of a device mesh — port of ``jckx/parallel/mesh.py``.

jckx lays a ``jax.sharding.Mesh`` over its chips: the batch is sharded on
the ``data`` axis, the state replicated, and XLA inserts the all-reduces of
the batch statistics and the gradients. PyTorch runs eagerly, so the port
names each collective itself. A mesh here is an object that the callers
pass down explicitly (to every ``bn_act``, the train steps, the metrics
engine); there is no module-level mesh.

Two kinds, one interface:

- ``ProcessMesh``: the ranks of the default ``torch.distributed`` process
  group on the ``data`` axis, one process per GPU (``torchrun``). NCCL on
  the card, gloo on the CPU. Training, ``evaluate`` and the fine-tune run
  on it. Without a process group it is a mesh of one rank whose
  collectives are the identity.
- ``LocalMesh``: devices of one process on the ``data`` axis, one worker
  thread per device (``run``). jckx serves from one process over a 1-D
  ``data`` mesh (``jckx/serve.py:328-356``), and so does the port. A list
  of devices may repeat one (``[cpu, cpu]`` in the tests, ``[cuda:0,
  cuda:0]`` on one card), as jckx's tests use virtual CPU devices.

Both give the callers the same operations:

- ``rows(x)``: this member's rows of a global batch (the counterpart of
  ``shard_batch`` / ``put_global``: every member holds the same global
  value and keeps its slice);
- ``all_reduce(t)``: the sum over the data axis of a small f32 tensor
  (the BN statistics). On a process mesh it is differentiable to any
  order when ``t`` requires grad (``_AllReduceSum``: its backward is the
  same all-reduce), which the WGAN-GP penalty needs: its input gradient
  runs through the statistics of every rank. On a local mesh the members
  add their partials in device order, so a render is the same from run
  to run;
- ``all_gather_rows(t)``: the members' rows concatenated in order;
- ``average_grads(params)`` (process mesh): the gradients averaged over
  the ranks through one flat buffer, one collective per call;
- ``any(flag)`` (process mesh): whether any rank raised a host flag.

A ``model`` axis of size 1 is accepted and does nothing, as in jckx; a
larger one is tensor or spatial parallelism, refused by name (``A13B``).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
A13B = "A13b (tensor / spatial parallel)"


def parse_mesh_shape(spec: str):
    """'4,2' → (4, 2); '' → None. The one parser for every CLI mesh flag."""
    return tuple(int(v) for v in str(spec).split(",")) if spec else None


def parse_mesh_axes(spec) -> tuple:
    """'data,model' (or a sequence) → ('data', 'model')."""
    if isinstance(spec, str):
        return tuple(a.strip() for a in spec.split(",") if a.strip()) or (DATA_AXIS,)
    return tuple(spec)


def check_mesh(shape: Optional[Sequence[int]], axes: Sequence[str] = (DATA_AXIS,)) -> None:
    """Raise ``ValueError`` for a mesh the port cannot run: axes other than
    ``data`` / ``model``, a shape whose rank differs from the axes', or a
    ``model`` axis larger than 1."""
    axes = tuple(axes)
    unknown = [a for a in axes if a not in (DATA_AXIS, MODEL_AXIS)]
    if unknown or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes}: each of {DATA_AXIS!r} and {MODEL_AXIS!r} at most once")
    if shape is None:
        return
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} has {len(shape)} axes, mesh_axes {axes} "
                         f"{len(axes)}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {tuple(shape)}: every axis needs at least 1 member")
    sizes = dict(zip(axes, shape))
    if sizes.get(MODEL_AXIS, 1) > 1:
        raise ValueError(f"a {MODEL_AXIS!r} axis of {sizes[MODEL_AXIS]} is tensor or spatial "
                         f"parallelism: not ported yet (ROADMAP.md {A13B}); the port runs the "
                         f"{DATA_AXIS!r} axis")


def local_batch_size(global_batch: int, mesh, axis: str = DATA_AXIS) -> int:
    """The rows of ``global_batch`` each member of ``mesh`` holds; raises
    when the data axis does not divide it (``jckx/train/gan_trainer.py:87-92``)."""
    n = mesh.shape.get(axis, 1) if mesh is not None else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data-axis size {n}")
    return global_batch // n


class _AllReduceSum(torch.autograd.Function):
    """Sum over the default process group, inside autograd: the backward of
    a sum over ranks is the same sum of the cotangents, and it is taken by
    this Function again, so the result is differentiable to any order."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


class Mesh:
    """The axes and sizes common to both kinds: ``shape`` maps each axis
    name to its size (jckx's ``Mesh.shape``), ``size`` is the data axis's."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        check_mesh(shape, axes)
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return self.shape.get(DATA_AXIS, 1)

    @property
    def rank(self) -> int:
        raise NotImplementedError

    def rows(self, x: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """The slice of a global batch (leading dim) that member ``rank``
        (default: this one) holds."""
        lb = local_batch_size(x.shape[0], self)
        r = self.rank if rank is None else rank
        return x[r * lb:(r + 1) * lb]

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class ProcessMesh(Mesh):
    """The ranks of the default process group on the data axis (the whole
    world). Without a process group: one rank, no collectives. ``device``
    holds the small tensors of ``any`` (NCCL takes CUDA tensors only)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], device=None):
        super().__init__(shape, axes)
        self.distributed = dist.is_available() and dist.is_initialized()
        self.device = torch.device("cpu" if device is None else device)

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.distributed else 0

    @property
    def lead(self) -> bool:
        """Rank 0: the one rank that writes files."""
        return self.rank == 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if not self.distributed:
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _AllReduceSum.apply(t)
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        if not self.distributed:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts)

    def average_grads(self, params) -> None:
        """Each parameter's ``.grad`` replaced by its mean over the ranks,
        through one flat buffer (one collective for the whole model)."""
        if not self.distributed:
            return
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat)
        flat.div_(self.size)
        for g, avg in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(avg)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of a tensor without gradient."""
        if not self.distributed:
            return t
        return self.all_reduce(t.detach()) / self.size

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def agree(self, flag: bool, what: str) -> bool:
        """``flag``, which every rank must hold alike (e.g. that a file to
        resume from exists); raises naming ``what`` where they differ."""
        if self.any(flag) and self.any(not flag):
            raise RuntimeError(f"the ranks disagree on whether {what}: every rank must read "
                               f"the same files (a save directory that all of them see)")
        return bool(flag)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any rank."""
        if not self.distributed:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item() > 0)


class LocalMesh(Mesh):
    """Devices of this process on the data axis, one worker thread each.
    ``run(fn)`` calls ``fn(i, device)`` for every member at once and
    returns the results in member order; inside it, ``rank`` is the
    calling thread's member and the collectives meet at a barrier. Each
    thread keeps its caller's grad and inference modes and runs on its
    device's current stream. The collectives take tensors without
    gradient: a local mesh serves inference."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], devices: Sequence):
        super().__init__(shape, axes)
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != self.size:
            raise ValueError(f"a local mesh of {self.size} members got {len(self.devices)} devices")
        self._tls = threading.local()
        self._barrier = threading.Barrier(self.size)
        self._slots: List = [None] * self.size
        self._run_lock = threading.Lock()

    @property
    def rank(self) -> int:
        r = getattr(self._tls, "index", None)
        if r is None:
            raise RuntimeError("LocalMesh.rank is defined inside LocalMesh.run only")
        return r

    def run(self, fn: Callable) -> list:
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
        results: List = [None] * self.size
        errors: List[BaseException] = []

        def member(i: int) -> None:
            dev = self.devices[i]
            self._tls.index = i
            try:
                with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                    if dev.type == "cuda":
                        with torch.cuda.device(dev):
                            results[i] = fn(i, dev)
                    else:
                        results[i] = fn(i, dev)
            except BaseException as e:  # noqa: BLE001 — re-raised by run() below
                errors.append(e)
                self._barrier.abort()  # the other members stop waiting for this one
            finally:
                self._tls.index = None

        with self._run_lock:  # one collective program on the mesh at a time
            self._barrier.reset()
            threads = [threading.Thread(target=member, args=(i,), name=f"jckx-mesh-{i}")
                       for i in range(self.size)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            first = next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                         errors[0])
            raise first
        return results

    def _exchange(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every member's ``t``, in member order, readable on this member's
        device and stream."""
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("a LocalMesh collective takes tensors without gradient "
                               "(a local mesh serves inference)")
        i = self.rank
        event = None
        if t.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
        self._slots[i] = (t, event)
        self._barrier.wait()
        own = self.devices[i]
        parts = []
        for p, ev in self._slots:
            if ev is not None and own.type == "cuda":
                torch.cuda.current_stream(own).wait_event(ev)
            elif ev is not None:
                ev.synchronize()
            parts.append(p.to(own))
        self._barrier.wait()  # every member has read the slots before any refills them
        return parts

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        parts = self._exchange(t)
        total = parts[0].clone()
        for p in parts[1:]:
            total = total + p
        return total

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._exchange(t))


def make_mesh(shape: Optional[Sequence[int]] = None, axes: Sequence[str] = (DATA_AXIS,),
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """Build a mesh. With ``devices``, a ``LocalMesh`` over them (jckx's
    rule: the first prod(shape) of them; default shape: all on ``data``).
    Without, a ``ProcessMesh`` over the default process group's world (or
    a world of one rank); its data axis must equal the world size.
    ``device`` is this rank's device (process mesh only)."""
    axes = parse_mesh_axes(axes)
    if devices is not None:
        devices = list(devices)
        if shape is None:
            shape, axes = (len(devices),), tuple(axes[:1]) or (DATA_AXIS,)
        check_mesh(shape, axes)
        total = math.prod(shape)
        if total > len(devices):
            raise ValueError(f"mesh shape {tuple(shape)} needs {total} devices, have {len(devices)}")
        return LocalMesh(shape, axes, devices[:total])
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if shape is None:
        shape, axes = (world,), tuple(axes[:1]) or (DATA_AXIS,)
    check_mesh(shape, axes)
    total = math.prod(shape)
    if total != world:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {total} ranks, have {world} (the process group's "
            f"world size): run one process per GPU, e.g. torchrun --nproc_per_node {total} "
            f"-m jckx_torch train --mesh_shape {','.join(map(str, shape))} --multihost")
    return ProcessMesh(shape, axes, device)


def process_mesh(mesh_shape: str = "", mesh_axes: str = DATA_AXIS, multihost: bool = False,
                 device=None, logger=None) -> Optional[ProcessMesh]:
    """The mesh of a training, evaluation or fine-tune process from its
    flags. A process group the caller already initialized is kept;
    otherwise one is brought up from torch's ``env://`` variables
    (``init_multihost``) when ``multihost`` is set or the mesh has more
    than one rank. → None for a lone process with no mesh asked for (one
    rank, no collectives, as before the mesh existed)."""
    from jckx_torch.utils.device import init_multihost

    shape, axes = parse_mesh_shape(mesh_shape), parse_mesh_axes(mesh_axes)
    check_mesh(shape, axes)
    if not dist.is_initialized() and (multihost or (shape and math.prod(shape) > 1)):
        ok, err = init_multihost(device)
        if not ok and logger is not None:
            logger.warning(f"--multihost: no process group ({type(err).__name__}: {err}); "
                           f"running as one rank")
    if shape is None and not dist.is_initialized():
        return None
    return make_mesh(shape, axes, device=device)
