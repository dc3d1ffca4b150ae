"""The device mesh — port of ``jckx/parallel/mesh.py``: its ``make_mesh``
(``:34-55``) over a ``data`` and a ``model`` axis, ``spatial_sharding``
(``:81-93``), ``reshard`` (``:138-149``) and ``tp_state_sharding``
(``:152-178``).

jckx lays a ``jax.sharding.Mesh`` over its chips and leaves the
collectives to GSPMD. PyTorch runs eagerly, so the port names each
collective itself. A mesh here is an object that the callers pass down
explicitly (to every ``bn_act``, the train steps, the metrics engine);
there is no module-level mesh.

Two kinds, one interface:

- ``ProcessMesh``: the ranks of the default ``torch.distributed`` process
  group laid out as a ``(D, M)`` grid on ``("data", "model")``, one process
  per GPU (``torchrun``). NCCL on the card, gloo on the CPU (and for ranks
  that share one card). Rank r sits at data index r // M and model index
  r % M, as jckx's ``np.array(devices).reshape(shape)`` places devices.
  Training runs on both axes; ``evaluate`` and the fine-tune on the data
  axis. Without a process group it is a mesh of one rank whose
  collectives are the identity.
- ``LocalMesh``: devices of one process on the ``data`` axis, one worker
  thread per device (``run``). jckx serves from one process over a 1-D
  ``data`` mesh (``jckx/serve.py:328-356``), and so does the port. A list
  of devices may repeat one (``[cpu, cpu]`` in the tests, ``[cuda:0,
  cuda:0]`` on one card), as jckx's tests use virtual CPU devices.

``size`` and ``rank`` are the data axis's: ``rows(x)`` is this member's
slice of a global batch (the counterpart of ``shard_batch`` /
``put_global``: every member holds the same global value and keeps its
slice). The M members of a model group hold the same rows and make the
same draws. ``model_size`` and ``model_rank`` are the model axis's.

The collectives take the axis they run over: ``"data"``, ``"model"`` or
``"world"`` (both). Each is one call here, counted in ``stats`` by kind
(calls, bytes, host seconds; calls and bytes also by the dtype on the wire):

- ``all_reduce(t, axis)``: the sum of a tensor (BN statistics, the
  penalty's input gradient). Inside autograd (``t`` requires grad) it is
  differentiable to any order: its backward is the same sum
  (``_AllReduceSum``). The WGAN-GP penalty differentiates through it;
- ``all_gather(t, dim, axis)`` / ``reduce_scatter(t, dim, axis)``: the
  members' slices of ``dim`` concatenated in order, and its adjoint, the
  sum over the members of which each keeps its slice. Each is the other's
  backward, so both are differentiable to any order;
- ``halo(x)`` (model axis, dim 2 of NCHW): x with one row of each
  neighbour on the model axis above and below it (zeros at the global
  edges). Its backward is its adjoint: each halo row's cotangent goes back
  to the neighbour that sent it and is added to that row there;
- ``all_gather_rows(t)``: the data axis's rows concatenated in order;
- ``average_grads(params, sharded)`` (process mesh): the gradients of the
  global mean loss, through one flat buffer per kind (below);
- ``any(flag)`` / ``agree`` / ``broadcast_object`` over the world. These
  read the host, so they stay outside every CUDA graph, at launch
  boundaries.

Captured collectives. A NCCL process mesh, or one with no process group,
is ``capturable``: its collectives can be recorded into a CUDA graph with
the work around them (``utils/graphs.py``), as jckx's compiled programs
hold theirs. gloo runs on the host and a ``LocalMesh`` meets at a host
barrier, so neither is; nor is a model axis > 1 on NCCL, whose halos and
channel gathers have not run between two cards (``eager_reason``). A
replay runs no Python, so ``stats`` cannot count its calls as they run:
the graph's eager warm call counts them (host seconds included), the
capture takes back what its own Python counted, and each replay adds the
warm call's calls and bytes (by kind and wire dtype) and counts them as
``replayed``, with no host seconds.

Gradients over a model axis. Each rank's autograd takes the exact adjoint
of every collective, so a rank's ``backward`` gives the gradient, for its
own copy of each leaf, of the sum over ALL ranks of their losses. The M
members of a model group compute the same loss, so that sum is M times the
data axis's. ``average_grads`` therefore sums a replicated leaf's copies
over the world and a sharded leaf's (one per data index) over the data
axis, and divides both by D·M: the gradient of the global mean loss, equal
on every copy. With M = 1 that is the data axis's mean. A
gradient that the step uses as a value rather than a cotangent (the
penalty's input gradient) is brought to the logical one by the layout
(``parallel/tp.py``, ``parallel/spatial.py``).

gloo on the card. NCCL cannot put two ranks on one GPU, so ranks that
share one run gloo. Its collectives follow one rule keyed on the backend
(``_STAGED``): a point-to-point exchange runs on host copies, a
reduce-scatter is an all-reduce of a host copy of which each member keeps
its slice, and a 16-bit float travels as f32 (``_wire``); ``stats`` counts
what travels, so a 16-bit tensor there counts as f32 bytes.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
WORLD = "world"  # both axes
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")  # BN's, never read


def parse_mesh_shape(spec: str):
    """'4,2' → (4, 2); '' → None. The one parser for every CLI mesh flag."""
    return tuple(int(v) for v in str(spec).split(",")) if spec else None


def parse_mesh_axes(spec) -> tuple:
    """'data,model' (or a sequence) → ('data', 'model')."""
    if isinstance(spec, str):
        return tuple(a.strip() for a in spec.split(",") if a.strip()) or (DATA_AXIS,)
    return tuple(spec)


def check_mesh(shape: Optional[Sequence[int]], axes: Sequence[str] = (DATA_AXIS,),
               model_axis: bool = False, what: str = "this command") -> None:
    """Raise ``ValueError`` for a mesh the port cannot run: axes other than
    ``data`` / ``model``, a shape whose rank differs from the axes', or a
    ``model`` axis larger than 1 where ``model_axis`` is off (serving,
    ``evaluate``, the fine-tune: jckx runs those on a ``data`` axis)."""
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
    if not model_axis and sizes.get(MODEL_AXIS, 1) > 1:
        raise ValueError(f"a {MODEL_AXIS!r} axis of {sizes[MODEL_AXIS]} shards a training run "
                         f"(--model_axis_mode tp|spatial); {what} runs on the {DATA_AXIS!r} "
                         f"axis only")


def local_batch_size(global_batch: int, mesh, axis: str = DATA_AXIS) -> int:
    """The rows of ``global_batch`` each member of ``mesh`` holds; raises
    when the data axis does not divide it (``jckx/train/gan_trainer.py:87-92``)."""
    n = mesh.shape.get(axis, 1) if mesh is not None else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data-axis size {n}")
    return global_batch // n


def spatial_sharding(x: torch.Tensor, mesh, dim: int = 2) -> torch.Tensor:
    """This member's rows of ``x``'s height (``dim``: 2 for NCHW, 1 for NHWC)
    over the model axis — ``spatial_sharding(mesh, "model")``'s layout, the
    height split in M contiguous blocks in model order."""
    m = mesh.model_size if mesh is not None else 1
    if m == 1:
        return x
    h = x.shape[dim]
    if h % m:
        raise ValueError(f"height {h} does not split over a model axis of {m}")
    return x.narrow(dim, mesh.model_rank * (h // m), h // m)


def tp_leaf_dim(shape, min_dim: int, m: int, out_dim: int = 0) -> Optional[int]:
    """jckx's tensor-parallel rule for one leaf (``tp_state_sharding``): a
    4-D convolution kernel is sharded on its output channels (``out_dim``:
    1 for a ``ConvTranspose2d``'s ``(in, out, k, k)``, 0 for a ``Conv2d``'s
    ``(out, in, k, k)``), a 1-D leaf on its length, each when that length is
    at least ``min_dim`` and divisible by ``m``. → the sharded dim, or None
    (replicated: everything else, 2-D matrices and scalars included)."""
    shape = tuple(shape)
    if len(shape) == 4 and shape[out_dim] >= min_dim and shape[out_dim] % m == 0:
        return out_dim
    if len(shape) == 1 and shape[0] >= min_dim and shape[0] % m == 0:
        return 0
    return None


def module_tp_dims(state_dict: Dict[str, torch.Tensor], transposed: bool, min_dim: int,
                   m: int) -> Dict[str, Optional[int]]:
    """``tp_leaf_dim`` for every parameter of a net's state dict (full
    shapes): G's convolutions are transposed, D's are not. BN's running
    buffers stay replicated (they are never read)."""
    return {k: None if k.endswith(_BUFFERS) else tp_leaf_dim(v.shape, min_dim, m, int(transposed))
            for k, v in state_dict.items()}


def tp_state_sharding(state: dict, mesh, min_dim: int = 128) -> dict:
    """The tensor-parallel layout of a checkpoint-shaped state (``model_g``,
    ``model_d``, optional ``ema_g``, ``optimizer_g`` / ``optimizer_d`` as
    torch state dicts of full tensors): the same tree with, at every
    tensor, its sharded dim over the model axis or None. Adam's moments
    and the EMA mirror their parameters; steps and scalars are replicated
    (jckx ``tp_state_sharding``)."""
    m = mesh.model_size if hasattr(mesh, "model_size") else mesh.shape.get(MODEL_AXIS, 1)
    out: dict = {}
    for key, transposed in (("model_g", True), ("ema_g", True), ("model_d", False)):
        if key in state:
            out[key] = module_tp_dims(state[key], transposed, min_dim, m)
    for key, net in (("optimizer_g", "model_g"), ("optimizer_d", "model_d")):
        if key in state:
            out[key] = optimizer_tp_dims(out[net], state[key])
    return out


def optimizer_tp_dims(net_dims: Dict[str, Optional[int]], opt_state: dict) -> dict:
    """The dims of a torch Adam state dict over a net whose parameters (in
    registration order, BN buffers skipped) have ``net_dims``: each moment
    mirrors its parameter, the step is replicated."""
    dims = [d for k, d in net_dims.items() if not k.endswith(_BUFFERS)]
    return {"state": {idx: {k: (dims[int(idx)] if isinstance(v, torch.Tensor) and v.dim() > 0
                                else None) for k, v in st.items()}
                      for idx, st in opt_state.get("state", {}).items()}}


def shard_tree(tree: dict, dims: dict, mesh) -> dict:
    """Full tensors → this member's slices where ``dims`` (a
    ``tp_state_sharding`` tree) names a dim; everything else as it is."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, dims.get(k) if isinstance(dims, dict) else None, mesh)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and isinstance(dims, int):
        return tree.chunk(mesh.model_size, dims)[mesh.model_rank].clone()
    return tree


def reshard(tree: dict, dims: dict, mesh) -> dict:
    """This member's slices → full tensors on every member of the model
    axis: each leaf that ``dims`` names a dim of is all-gathered along it
    (jckx ``reshard(tree, replicated)``). Every member must call it, with
    the same tree."""
    if isinstance(tree, dict):
        return {k: reshard(v, dims.get(k) if isinstance(dims, dict) else None, mesh)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and isinstance(dims, int):
        with torch.no_grad():
            return mesh.all_gather(tree, dims, MODEL_AXIS)
    return tree


def _like(out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``out`` in ``t``'s memory format (channels_last for an activation)."""
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last):
        return out.contiguous(memory_format=torch.channels_last)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over a mesh axis, inside autograd: the backward of a sum over
    ranks is the same sum of the cotangents, and it is taken by this
    Function again, so the result is differentiable to any order."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    """The members' slices concatenated along ``dim``; backward: the
    reduce-scatter of the cotangent (``_ReduceScatter``)."""

    @staticmethod
    def forward(ctx, t, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh._all_gather(t, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.mesh, ctx.dim, ctx.axis), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the members, of which each keeps its slice of ``dim``;
    backward: the all-gather of the cotangent (``_AllGather``)."""

    @staticmethod
    def forward(ctx, t, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh._reduce_scatter(t, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.mesh, ctx.dim, ctx.axis), None, None, None


class _Halo(torch.autograd.Function):
    """x (N, C, h, W) → (N, C, h + 2, W): the last row of the member above
    on the model axis, x, the first row of the member below (zeros at the
    global edges); backward: ``_HaloAdjoint``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        from_up, from_down = mesh._neighbours(x[:, :, :1], x[:, :, -1:])
        return torch.cat([from_up, x, from_down], dim=2)

    @staticmethod
    def backward(ctx, g):
        return _HaloAdjoint.apply(g, ctx.mesh), None


class _HaloAdjoint(torch.autograd.Function):
    """The adjoint of ``_Halo``: g (N, C, h + 2, W) → (N, C, h, W), its
    middle rows plus the halo rows of the neighbours sent back (the one
    below's top row onto the last row, the one above's bottom row onto
    the first); backward: ``_Halo``."""

    @staticmethod
    def forward(ctx, g, mesh):
        ctx.mesh = mesh
        # my top halo row came from the member above: it goes back up, and so on
        from_up, from_down = mesh._neighbours(g[:, :, :1], g[:, :, -1:])
        out = g[:, :, 1:-1].clone()
        out[:, :, :1] += from_up
        out[:, :, -1:] += from_down
        return out

    @staticmethod
    def backward(ctx, gg):
        return _Halo.apply(gg, ctx.mesh), None


class CollectiveStats:
    """Calls, bytes and host seconds of the mesh's collectives, by kind, and
    the calls and bytes of each kind by the dtype that went over the wire
    (``by_dtype[kind][dtype] = [calls, bytes]``; ``utils/comm.py`` reads it).
    ``replayed[kind]`` of the calls ran inside CUDA graph replays, which
    have no host seconds of their own (module docstring)."""

    KINDS = ("all_reduce", "all_gather", "reduce_scatter", "halo_send_recv")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = {k: 0 for k in self.KINDS}
        self.bytes = {k: 0 for k in self.KINDS}
        self.seconds = {k: 0.0 for k in self.KINDS}
        self.replayed = {k: 0 for k in self.KINDS}
        self.by_dtype: Dict[str, Dict[torch.dtype, List[int]]] = {k: {} for k in self.KINDS}

    def add(self, kind: str, nbytes: int, seconds: float, dtype: torch.dtype,
            calls: int = 1) -> None:
        self.calls[kind] += calls
        self.bytes[kind] += int(nbytes)
        self.seconds[kind] += seconds
        entry = self.by_dtype[kind].setdefault(dtype, [0, 0])
        entry[0] += calls
        entry[1] += int(nbytes)

    def snapshot(self) -> dict:
        """A copy of every count, for ``since`` and ``restore``."""
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "seconds": dict(self.seconds), "replayed": dict(self.replayed),
                "by_dtype": {k: {dt: list(v) for dt, v in m.items()}
                             for k, m in self.by_dtype.items()}}

    def since(self, snap: dict) -> tuple:
        """The calls counted since ``snap``: ``((kind, dtype, calls, bytes), ...)``."""
        out = []
        for kind, m in self.by_dtype.items():
            for dt, (calls, nbytes) in m.items():
                c0, b0 = snap["by_dtype"][kind].get(dt, (0, 0))
                if calls != c0:
                    out.append((kind, dt, calls - c0, nbytes - b0))
        return tuple(out)

    def restore(self, snap: dict) -> None:
        """Every count back to ``snap``'s."""
        self.calls, self.bytes = dict(snap["calls"]), dict(snap["bytes"])
        self.seconds, self.replayed = dict(snap["seconds"]), dict(snap["replayed"])
        self.by_dtype = {k: {dt: list(v) for dt, v in m.items()}
                         for k, m in snap["by_dtype"].items()}

    def add_replayed(self, collectives: tuple) -> None:
        """One replay of a graph whose call made ``collectives`` (``since``'s form)."""
        for kind, dt, calls, nbytes in collectives:
            self.add(kind, nbytes, 0.0, dt, calls)
            self.replayed[kind] += calls

    def as_dict(self) -> dict:
        return {k: {"calls": self.calls[k], "bytes": self.bytes[k], "host_s": self.seconds[k],
                    "replayed_calls": self.replayed[k]} for k in self.KINDS}


class Mesh:
    """The axes and sizes common to both kinds: ``shape`` maps each axis
    name to its size (jckx's ``Mesh.shape``), ``size`` is the data axis's."""

    model_axis = False  # whether this kind of mesh may hold a model axis > 1

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        check_mesh(shape, axes, model_axis=self.model_axis, what="a local mesh (serving)")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return self.shape.get(DATA_AXIS, 1)

    @property
    def model_size(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def model_rank(self) -> int:
        return 0

    @property
    def rank(self) -> int:
        raise NotImplementedError

    def axis_size(self, axis: str) -> int:
        return {DATA_AXIS: self.size, MODEL_AXIS: self.model_size,
                WORLD: self.size * self.model_size}[axis]

    def rows(self, x: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """The slice of a global batch (leading dim) that member ``rank``
        (default: this one) holds."""
        lb = local_batch_size(x.shape[0], self)
        r = self.rank if rank is None else rank
        return x[r * lb:(r + 1) * lb]

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


# backends whose point-to-point and reduce-scatter run on host copies
_STAGED = ("gloo",)


class ProcessMesh(Mesh):
    """The ranks of the default process group as a (data, model) grid; see
    the module docstring. Without a process group: one rank, no
    collectives. ``device`` holds the small tensors of ``any`` (NCCL takes
    CUDA tensors only). Every rank builds every sub-group, in the same
    order: one ``model`` group per data index, one ``data`` group per
    model index."""

    model_axis = True

    def __init__(self, shape: Sequence[int], axes: Sequence[str], device=None):
        super().__init__(shape, axes)
        self.distributed = dist.is_available() and dist.is_initialized()
        self.device = torch.device("cpu" if device is None else device)
        self.stats = CollectiveStats()
        self.global_rank = dist.get_rank() if self.distributed else 0
        self.backend = dist.get_backend() if self.distributed else None
        d, m = self.size, self.model_size
        self._groups: Dict[str, object] = {WORLD: None, DATA_AXIS: None, MODEL_AXIS: None}
        self._staged = self.backend in _STAGED
        if self.distributed and m > 1:
            for i in range(d):
                g = dist.new_group(list(range(i * m, (i + 1) * m)))
                if i == self.rank:
                    self._groups[MODEL_AXIS] = g
            for j in range(m):
                g = dist.new_group(list(range(j, d * m, m)))
                if j == self.model_rank:
                    self._groups[DATA_AXIS] = g

    @property
    def rank(self) -> int:
        """This rank's index on the data axis."""
        return self.global_rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.global_rank % self.model_size

    @property
    def lead(self) -> bool:
        """World rank 0: the one rank that writes files."""
        return self.global_rank == 0

    @property
    def capturable(self) -> bool:
        """NCCL's collectives (or none at all) can be captured; gloo's run
        on the host."""
        return self.backend in (None, "nccl")

    def eager_reason(self) -> str:
        """Why work over this mesh cannot be one CUDA graph; "" where it can."""
        if not self.capturable:
            return f"its {self.backend} collectives run on the host"
        if self.model_size > 1:
            return (f"its model axis of {self.model_size} (halo exchanges and channel gathers "
                    f"over NCCL wait for a machine with two or more cards)")
        return ""

    def _live(self, axis: str) -> bool:
        return self.distributed and self.axis_size(axis) > 1

    def _sum(self, t: torch.Tensor, axis: str) -> None:
        """The sum of ``t`` over ``axis``, in place: the one call through
        which every sum goes over the wire."""
        dist.all_reduce(t, group=self._groups[axis])

    def _timed(self, kind: str, wire: torch.Tensor, nbytes: int, fn: Callable):
        """``fn()``, counted as one ``kind`` call of ``nbytes`` in ``wire``'s dtype."""
        t0 = time.perf_counter()
        out = fn()
        self.stats.add(kind, nbytes, time.perf_counter() - t0, wire.dtype)
        return out

    # ---- raw collectives (no autograd) --------------------------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """What a collective sends: on a staged backend a 16-bit float
        travels (and is summed) as f32, rounded once on the way back."""
        if self._staged and t.dtype in (torch.bfloat16, torch.float16):
            return t.float()
        return t

    def _all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        out = self._wire(t.detach()).clone(memory_format=torch.contiguous_format)
        if self._live(axis):
            self._timed("all_reduce", out, out.numel() * out.element_size(),
                        lambda: self._sum(out, axis))
        return out.to(t.dtype)

    def _all_gather(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        if not self._live(axis):
            return t.detach().clone()
        part = self._wire(t.detach()).contiguous()
        parts = [torch.empty_like(part) for _ in range(self.axis_size(axis))]
        self._timed("all_gather", part, part.numel() * part.element_size() * len(parts),
                    lambda: dist.all_gather(parts, part, group=self._groups[axis]))
        return _like(torch.cat(parts, dim=dim).to(t.dtype), t)

    def _reduce_scatter(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        n = self.axis_size(axis)
        idx = self.model_rank if axis == MODEL_AXIS else self.rank
        if not self._live(axis):
            return t.detach().clone()
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} does not split "
                             f"over {n} members")
        full = t.detach().contiguous()
        if self._staged:
            # a 16-bit float is summed in f32 and rounded once
            host = full.to("cpu", torch.promote_types(full.dtype, torch.float32), copy=True)
            self._timed("reduce_scatter", host, host.numel() * host.element_size(),
                        lambda: self._sum(host, axis))
            out = host.chunk(n, dim)[idx].to(t.device, t.dtype)
        else:
            chunks = [c.contiguous() for c in full.chunk(n, dim)]
            out = torch.empty_like(chunks[idx])
            self._timed("reduce_scatter", full, full.numel() * full.element_size(),
                        lambda: dist.reduce_scatter(out, chunks, group=self._groups[axis]))
        return _like(out, t)

    def _neighbours(self, to_up: torch.Tensor, to_down: torch.Tensor):
        """Send ``to_up`` to the model-axis member above and ``to_down`` to
        the one below; → (what the one above sent down, what the one below
        sent up), zeros where there is no neighbour."""
        m, i = self.model_size, self.model_rank
        recv_up, recv_down = torch.zeros_like(to_down), torch.zeros_like(to_up)
        if not self._live(MODEL_AXIS):
            return recv_up, recv_down
        dev, dtype = to_up.device, to_up.dtype
        stage = ((lambda t: self._wire(t).to("cpu").contiguous()) if self._staged
                 else (lambda t: t.contiguous()))
        s_up, s_down = stage(to_up), stage(to_down)
        r_up, r_down = stage(recv_up), stage(recv_down)
        group = self._groups[MODEL_AXIS]
        ops = []
        if i > 0:
            ops += [dist.P2POp(dist.isend, s_up, self.global_rank - 1, group),
                    dist.P2POp(dist.irecv, r_up, self.global_rank - 1, group)]
        if i < m - 1:
            ops += [dist.P2POp(dist.isend, s_down, self.global_rank + 1, group),
                    dist.P2POp(dist.irecv, r_down, self.global_rank + 1, group)]

        def run():
            for w in dist.batch_isend_irecv(ops):
                w.wait()

        self._timed("halo_send_recv", s_up, sum(op.tensor.numel() * op.tensor.element_size()
                                                for op in ops), run)
        return r_up.to(dev, dtype), r_down.to(dev, dtype)

    # ---- the collectives the callers use --------------------------------

    def all_reduce(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        if not self._live(axis):
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _AllReduceSum.apply(t, self, axis)
        return self._all_reduce(t, axis)

    def all_gather(self, t: torch.Tensor, dim: int, axis: str = MODEL_AXIS) -> torch.Tensor:
        if not self._live(axis):
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _AllGather.apply(t, self, dim, axis)
        return self._all_gather(t, dim, axis)

    def reduce_scatter(self, t: torch.Tensor, dim: int, axis: str = MODEL_AXIS) -> torch.Tensor:
        if not self._live(axis):
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _ReduceScatter.apply(t, self, dim, axis)
        return self._reduce_scatter(t, dim, axis)

    def halo(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C, h, W) with a row of each model-axis neighbour around it
        (``_Halo``); zeros at the global edges (and with no model axis)."""
        if torch.is_grad_enabled() and x.requires_grad and self._live(MODEL_AXIS):
            out = _Halo.apply(x, self)
        else:
            up, down = self._neighbours(x[:, :, :1], x[:, :, -1:])
            out = torch.cat([up, x, down], dim=2)
        return out.contiguous(memory_format=torch.channels_last)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        if not self._live(DATA_AXIS):
            return t
        return self._all_gather(t, 0, DATA_AXIS)

    def average_grads(self, params, sharded: Sequence[bool] = ()) -> None:
        """Each parameter's ``.grad`` replaced by the gradient of the global
        mean loss (module docstring): the copies of a replicated leaf summed
        over the world, those of a leaf sharded on the model axis
        (``sharded[i]``) over the data axis, both divided by D·M; one flat
        buffer, one collective, per kind."""
        if not self.distributed:
            return
        params = list(params)
        sharded = list(sharded) or [False] * len(params)
        total = self.size * self.model_size
        for want, axis in ((False, WORLD), (True, DATA_AXIS)):
            grads = [p.grad for p, s in zip(params, sharded) if s == want and p.grad is not None]
            if not grads:
                continue
            flat = torch._utils._flatten_dense_tensors(grads)
            flat = self._all_reduce(flat, axis).div_(total)
            for g, avg in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
                g.copy_(avg)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the data axis of a tensor without gradient."""
        if not self._live(DATA_AXIS):
            return t
        return self._all_reduce(t, DATA_AXIS) / self.size

    def broadcast_object(self, obj):
        """World rank 0's ``obj`` (picklable) on every rank."""
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

    def eager_reason(self) -> str:
        """Why serving over this mesh stays eager (``ProcessMesh.eager_reason``)."""
        return "a local mesh renders from one thread per device and meets at a host barrier"

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

    def all_reduce(self, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
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
    a world of one rank), whose axes' product must equal the world size.
    ``device`` is this rank's device (process mesh only)."""
    axes = parse_mesh_axes(axes)
    if devices is not None:
        devices = list(devices)
        if shape is None:
            shape, axes = (len(devices),), tuple(axes[:1]) or (DATA_AXIS,)
        check_mesh(shape, axes, model_axis=True)
        total = math.prod(shape)
        if total > len(devices):  # jckx's first refusal; a model axis is LocalMesh's
            raise ValueError(f"mesh shape {tuple(shape)} needs {total} devices, have {len(devices)}")
        return LocalMesh(shape, axes, devices[:total])
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if shape is None:
        shape, axes = (world,), tuple(axes[:1]) or (DATA_AXIS,)
    check_mesh(shape, axes, model_axis=True)
    total = math.prod(shape)
    if total != world:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {total} ranks, have {world} (the process group's "
            f"world size): run one process per GPU, e.g. torchrun --nproc_per_node {total} "
            f"-m jckx_torch train --mesh_shape {','.join(map(str, shape))} --multihost")
    return ProcessMesh(shape, axes, device)


def process_mesh(mesh_shape: str = "", mesh_axes: str = DATA_AXIS, multihost: bool = False,
                 device=None, logger=None, model_axis: bool = False,
                 what: str = "this command") -> Optional[ProcessMesh]:
    """The mesh of a training, evaluation or fine-tune process from its
    flags. A process group the caller already initialized is kept;
    otherwise one is brought up from torch's ``env://`` variables
    (``init_multihost``) when ``multihost`` is set or the mesh has more
    than one rank. ``model_axis``: a ``model`` axis > 1 is allowed (train);
    elsewhere it is refused naming ``what``. → None for a lone process with
    no mesh asked for (one rank, no collectives, as before the mesh
    existed)."""
    from jckx_torch.utils.device import init_multihost

    shape, axes = parse_mesh_shape(mesh_shape), parse_mesh_axes(mesh_axes)
    check_mesh(shape, axes, model_axis=model_axis, what=what)
    if not dist.is_initialized() and (multihost or (shape and math.prod(shape) > 1)):
        ok, err = init_multihost(device)
        if not ok and logger is not None:
            logger.warning(f"--multihost: no process group ({type(err).__name__}: {err}); "
                           f"running as one rank")
    if shape is None and not dist.is_initialized():
        return None
    return make_mesh(shape, axes, device=device)
