"""Children of the port's model-axis CPU tests: each function runs in one
rank of a gloo process group that ``_torch_dp_child.spawn`` starts, over a
``(D, M)`` process mesh on ``("data", "model")``, imports only torch and
``jckx_torch``, and writes what it computed to ``<out>/rank<r>.pt``.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_dp_child import COLLECTIVE_TIMEOUT, RenderStub, _finish, _nets


def group(rank: int, shape: tuple, store: str):
    """One thread, the gloo group over the file store, the (D, M) mesh."""
    from jckx_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=shape[0] * shape[1],
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    return make_mesh(tuple(shape), ("data", "model"), device="cpu")


# ------------------------------------------------------------ collectives

def collectives_rank(rank: int, shape: tuple, store: str, inputs: str, out: str) -> None:
    """The model axis's all-gather, reduce-scatter and halo exchange on
    f64 inputs, every rank taking its part of the global tensors: their
    values; ``gradcheck`` and ``gradgradcheck`` of each, with one rank
    active at a time (its input varies, the other's output is multiplied
    by 0, so the checked function is the active rank's own block and
    every rank runs the same collectives in lockstep); and the spatial
    layout's convolution and transposed convolution on blocks of a global
    input, with the gradients of a loss whose sum over the ranks is the
    unsharded one's."""
    from jckx_torch.parallel.mesh import MODEL_AXIS
    from jckx_torch.parallel.spatial import Spatial

    mesh = group(rank, shape, store)
    data = torch.load(inputs, weights_only=False)
    x, y, img = data["x"], data["y"], data["img"]
    m, i = mesh.model_size, mesh.model_rank
    parts = {"gather": x.chunk(m, 1)[i].clone(), "scatter": y[i].clone(),
             "halo": img.chunk(m, 2)[i].clone()}
    ops = {"gather": lambda t: mesh.all_gather(t, 1, MODEL_AXIS),
           "scatter": lambda t: mesh.reduce_scatter(t, 1, MODEL_AXIS),
           "halo": mesh.halo}
    rec = {name: ops[name](parts[name]) for name in ops}
    checks = {}
    for name, op in ops.items():
        for active in range(m):
            if i == active:
                fn = lambda t, op=op: op(t) ** 2  # noqa: E731
            else:
                fn = lambda t, op=op, c=parts[name].clone(): 0.0 * op(c + 0.0 * t) ** 2  # noqa: E731
            a = parts[name].clone().requires_grad_(True)  # gradcheck perturbs it in place
            checks[(name, active)] = (
                torch.autograd.gradcheck(fn, (a,), raise_exception=False),
                torch.autograd.gradgradcheck(fn, (a,), raise_exception=False))
    rec["checks"] = checks
    lay = Spatial(mesh)
    conv = {}
    for name, w in (("conv", data["w_conv"]), ("convt", data["w_convt"])):
        h = data["conv_x"].shape[2]
        xb = lay.block(data["conv_x"], h).detach().requires_grad_(True)
        wr = w.detach().clone().requires_grad_(True)
        run = lay.conv2d if name == "conv" else lay.conv_transpose2d
        out_b = run(xb, wr, 2, 1, h)
        (out_b * data[f"v_{name}"].chunk(m, 2)[i]).sum().backward()
        conv[name] = {"out": out_b.detach(), "dx": xb.grad, "dw": wr.grad}
    rec["conv"] = conv
    _finish(out, rank, rec)


# ------------------------------------------------------------ train steps

def run_step_case(case: dict, mesh) -> dict:
    """The port's train step on ``case`` over the (D, M) mesh (each data
    index steps on its rows; ``cfg`` carries ``model_axis_mode``). → the
    telemetry of every step and the final full parameters."""
    from jckx_torch.checkpoint.checkpoint import state_payload
    from jckx_torch.configs import Config
    from jckx_torch.train.state import create_dcgan_state
    from jckx_torch.train.steps import (METRIC_NAMES, StepDraws, make_cgan_train_step,
                                        make_dcgan_train_step, shard_draws)

    cfg = Config()
    for k, v in case["cfg"].items():
        setattr(cfg, k, v)
    geo, G, D = _nets(case)
    ts = create_dcgan_state(cfg, G, D, mesh)
    make = make_cgan_train_step if case["conditional"] else make_dcgan_train_step
    step = make(cfg, geo, mesh)
    telemetry = []
    for real, onehot, draws in zip(case["real"], case["onehot"], case["draws"]):
        d = shard_draws(StepDraws(**{k: None if v is None else torch.from_numpy(v)
                                     for k, v in draws.items()}), mesh)
        args = (mesh.rows(torch.from_numpy(real)),)
        if case["conditional"]:
            args += (mesh.rows(torch.from_numpy(onehot)),)
        m = step(ts, *args, d)
        telemetry.append([float(m[k]) for k in METRIC_NAMES])
    payload = state_payload(ts)
    sharded = sorted(k for net in (ts.G, ts.D)
                     for k, d in (getattr(net, "tp_dims", None) or {}).items() if d is not None)
    return {"telemetry": np.array(telemetry), "G": payload["model_g"], "D": payload["model_d"],
            "opt_g": payload["optimizer_g"], "opt_d": payload["optimizer_d"], "sharded": sharded}


def step_cases_rank(rank: int, shape: tuple, store: str, inputs: str, out: str) -> None:
    mesh = group(rank, shape, store)
    data = torch.load(inputs, weights_only=False)
    _finish(out, rank, {name: run_step_case(case, mesh) for name, case in data["cases"].items()})


def train_rank(rank: int, shape: tuple, store: str, argv: list, out: str) -> None:
    """``jckx_torch.train.main.run`` over the mesh with ``RenderStub``
    metrics; "{rank}" in ``argv`` is replaced by the rank."""
    from jckx_torch.configs import get_arg_parse
    from jckx_torch.train import main as tmain

    group(rank, shape, store)
    tr = tmain.run(get_arg_parse([a.replace("{rank}", str(rank)) for a in argv]),
                   metrics=RenderStub())
    _finish(out, rank, {"step": tr.state.step, "evals": tr.evals})


# ------------------------------------------------------------ the planner's step

def plan_stats_rank(rank: int, shape: tuple, store: str, cases: dict, out: str) -> None:
    """The collectives of the trainer's second step (uint8 zeros decoded,
    weights drawn from the config's seed) on a real gloo group, for each
    case (name → (mesh shape, config fields)): every kind's calls and bytes
    and the dtypes on the wire, to hold ``jckx_torch.plan``'s fake-group
    inventory against."""
    from jckx_torch.configs import Config
    from jckx_torch.data.pipeline import decode_batch
    from jckx_torch.models.dcgan import Discriminator, Generator
    from jckx_torch.parallel import make_mesh
    from jckx_torch.train.state import create_dcgan_state, geometry
    from jckx_torch.train.steps import make_dcgan_train_step

    group(rank, shape, store)
    rec = {}
    for name, (mesh_shape, fields) in cases.items():
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
        cfg = Config()
        for k, v in fields.items():
            setattr(cfg, k, v)
        geo = geometry(cfg)
        gen = torch.Generator().manual_seed(cfg.seed)
        state = create_dcgan_state(cfg, Generator(geo, gen=gen), Discriminator(geo, gen=gen), mesh)
        step = make_dcgan_train_step(cfg, geo, mesh)
        u8 = torch.zeros((cfg.batch_size // mesh.size, cfg.image_size, cfg.image_size,
                          cfg.channels), dtype=torch.uint8)
        for i in range(2):
            if i == 1:
                mesh.stats.reset()
            step(state, decode_batch(u8, cfg.image_size))
        rec[name] = {"calls": dict(mesh.stats.calls), "bytes": dict(mesh.stats.bytes),
                     "dtypes": {k: sorted(str(d) for d in v)
                                for k, v in mesh.stats.by_dtype.items()}}
    _finish(out, rank, rec)


# ------------------------------------------------------------ f64 first step

F64_GEOMETRY = dict(image_size=64, base_width=16, batch_size=8)


def f64_first_step(mesh=None, mode: str = "spatial") -> dict:
    """One DCGAN step at 64², width 16, batch 8 from seeded weights and a
    seeded batch, computed in f64 (the step's compute dtype patched; the
    parameters and Adam stay f32), over ``mesh`` in ``mode``'s layout or
    alone. → the telemetry."""
    from jckx_torch.configs import Config
    from jckx_torch.models.dcgan import Discriminator, Generator
    from jckx_torch.train import steps
    from jckx_torch.train.state import create_dcgan_state, geometry

    cfg = Config()
    for k, v in F64_GEOMETRY.items():
        setattr(cfg, k, v)
    cfg.compute_dtype, cfg.model_axis_mode, cfg.max_learning_rate = "float32", mode, 2e-4
    geo = geometry(cfg)
    gen = torch.Generator().manual_seed(0)
    state = create_dcgan_state(cfg, Generator(geo, gen=gen), Discriminator(geo, gen=gen), mesh)
    real = torch.rand(cfg.batch_size, cfg.image_size, cfg.image_size, 3,
                      generator=torch.Generator().manual_seed(1)) * 2 - 1
    m = steps.make_dcgan_train_step(cfg, geo, mesh)(state, real)
    return {k: float(m[k]) for k in steps.METRIC_NAMES}


def f64_step_rank(rank: int, shape: tuple, store: str, out: str) -> None:
    from jckx_torch.train import steps

    mesh = group(rank, shape, store)
    steps.compute_dtype = lambda cfg: torch.float64
    _finish(out, rank, f64_first_step(mesh))
