"""Capacity planner — port of ``jckx/plan.py``: what one mesh member's
train step costs in FLOPs, memory traffic, memory and cross-shard traffic,
and which floor bounds it, against an H100's peaks.

    python -m jckx_torch plan -m DCGAN -b 128                  # 8 data ranks
    python -m jckx_torch plan --devices 2 --mesh_shape 1,2 \\
        --mesh_axes data,model --model_axis_mode spatial
    python -m jckx_torch plan --device cpu --devices 8 --image_size 16 -b 16

jckx compiles its step ahead of time for a detached TPU topology and reads
XLA's cost model. PyTorch has no ahead-of-time program, so the port runs
the trainer's real step, as rank 0 of a mesh of ``--devices`` ranks over
torch's fake process group (``FakeStore``): the mesh builds its groups
unchanged, and every collective is a call that moves nothing and is
counted by the mesh. The step is the trainer's (``_build``): the uint8
batch of this rank's rows decoded, then the DCGAN or CGAN step in the
layout that ``--model_axis_mode`` and ``--tp_min_dim`` select, on initial
weights drawn from ``--seed``. It runs twice, since torch's Adam makes its
moments at its first step (jckx's ``tx.init`` counts them among the
arguments); the second is measured:

- ``step_flops`` and ``step_hbm_bytes``: ``utils/cost.StepCost`` over the
  step (bytes unfused: an upper bound);
- ``cross_shard_ops`` / ``cross_shard_bytes``: the mesh's counts through
  ``utils/comm.comm_inventory``. The fake group is not gloo, so a 16-bit
  tensor counts at its own width, as NCCL sends it;
- ``memory``: on a card, ``torch.cuda``'s allocator around the step; the
  CPU has none to read (jckx's ``{"error": ...}``).

The fake group's results are not values (an all-gather leaves its output
as allocated), so the step's numbers are meaningless; the planner reads
only what does not depend on them. Like every entry point of the port it
runs on the card unless ``--device cpu`` is given, and it refuses to start
inside an existing process group (``torchrun``). Prints ONE JSON report
with jckx's keys.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch
import torch.distributed as dist

# H100 SXM data sheet; override per target via flags
H100_BF16_FLOPS = 989e12  # dense, tensor cores
H100_HBM_BYTES_PER_S = 3350e9
H100_NVLINK_BYTES_PER_S = 450e9  # NVLink 4, one direction per GPU
H100_HBM_BYTES = 80 * 1024**3


def _build(cfg, mesh, device: torch.device):
    """→ (step, state): the trainer's one step (``gan_trainer._train_step``
    on ``create_dcgan_state`` and the family's step maker) on a uint8 batch
    of zeros, this rank's ``batch_size / D`` rows, over ``mesh``."""
    from jckx_torch.data.pipeline import decode_batch, one_hot
    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.models.dcgan import Discriminator, Generator
    from jckx_torch.parallel.mesh import local_batch_size
    from jckx_torch.train.state import create_dcgan_state, geometry
    from jckx_torch.train.steps import (compute_dtype, make_cgan_train_step,
                                        make_dcgan_train_step)

    conditional = cfg.model == "CGAN"
    geo = geometry(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)  # train.main.run's draw order
    if conditional:
        G, D = CGenerator(geo, cfg.num_classes, gen=gen), CDiscriminator(geo, cfg.num_classes, gen=gen)
    else:
        G, D = Generator(geo, gen=gen), Discriminator(geo, gen=gen)
    state = create_dcgan_state(cfg, G.to(device), D.to(device), mesh)
    base = (make_cgan_train_step if conditional else make_dcgan_train_step)(cfg, geo, mesh)
    rows = local_batch_size(cfg.batch_size, mesh)
    u8 = torch.zeros((rows, cfg.image_size, cfg.image_size, cfg.channels), dtype=torch.uint8,
                     device=device)
    labels = torch.zeros((rows,), dtype=torch.int64, device=device)

    def step():
        real = decode_batch(u8, cfg.image_size, compute_dtype(cfg))
        if conditional:
            return base(state, real, one_hot(labels, cfg.num_classes))
        return base(state, real)

    return step, state


def _state_bytes(state) -> int:
    """The bytes of the train state: both nets, the EMA, Adam's moments."""
    seen = {}
    for net in (state.G, state.D, state.ema_g):
        if net is not None:
            seen.update({t.data_ptr(): t for t in net.state_dict().values()})
    for opt in (state.opt_g, state.opt_d):
        for st in opt.state.values():
            seen.update({t.data_ptr(): t for t in st.values() if isinstance(t, torch.Tensor)})
        if hasattr(opt, "master"):  # ShardedAdam's slice of the flat parameters
            seen[opt.master.data_ptr()] = opt.master
    return sum(t.numel() * t.element_size() for t in seen.values())


def _measure(step, state, device: torch.device, hbm_gib: float):
    """Run the measured step → (StepCost, memory report)."""
    from jckx_torch.utils.cost import StepCost

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        argument = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with StepCost() as cost:
        step()
    if not on_card:
        return cost, {"error": f"no device memory to read on {device} (the CPU has no "
                               f"allocator statistics): plan --device cuda reads the card's"}
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    mb = lambda n: round(n / 2**20, 1)  # noqa: E731
    return cost, {"argument_mb": mb(argument), "output_mb": mb(_state_bytes(state)),
                  "temp_mb": mb(peak - argument), "peak_mb": mb(peak),
                  "hbm_mb": round(hbm_gib * 1024, 1), "fits": peak < hbm_gib * 1024**3}


def plan(argv=None) -> dict:
    from jckx_torch.configs import get_arg_parse
    from jckx_torch.parallel.mesh import make_mesh, parse_mesh_axes, parse_mesh_shape
    from jckx_torch.utils.comm import comm_inventory
    from jckx_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(
        prog="jckx_torch.plan", allow_abbrev=False,  # --device is the config's, not --devices
        description="capacity planner: one rank's real train step over a fake process group "
                    "(unknown flags forward to the training config: -m, -b, --image_size, "
                    "--mesh_shape, --model_axis_mode, --device, ...)")
    p.add_argument("--topology", default="",
                   help="'' (the only value): --devices fake ranks; a TPU topology name is "
                        "jckx's (python -m jckx.plan)")
    p.add_argument("--devices", type=int, default=8, help="ranks of the planned mesh")
    p.add_argument("--peak_tflops", type=float, default=H100_BF16_FLOPS / 1e12)
    p.add_argument("--hbm_gbps", type=float, default=H100_HBM_BYTES_PER_S / 1e9)
    p.add_argument("--ici_gbps", type=float, default=H100_NVLINK_BYTES_PER_S / 1e9,
                   help="the interconnect's rate per GPU (NVLink 4, one direction)")
    p.add_argument("--hbm_gib", type=float, default=H100_HBM_BYTES / 1024**3)
    args, rest = p.parse_known_args(argv)
    if args.topology:
        raise SystemExit(f"--topology {args.topology!r} names a TPU topology: compile for it "
                         f"with python -m jckx.plan; the port plans --devices ranks of its "
                         f"own (--topology '')")
    cfg = get_arg_parse(rest)
    device = resolve_device(cfg.device)
    shape = parse_mesh_shape(cfg.mesh_shape) or (args.devices,)
    axes = parse_mesh_axes(cfg.mesh_axes)[: len(shape)]
    if math.prod(shape) != args.devices:
        raise SystemExit(f"--mesh_shape {shape} needs {math.prod(shape)} devices; --devices "
                         f"gives {args.devices}")
    if dist.is_initialized():
        raise SystemExit("plan runs one process over a fake process group of its own; a "
                         "process group is already initialized here (torchrun?)")

    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=args.devices)
    try:
        mesh = make_mesh(shape, axes, device=device)
        step, state = _build(cfg, mesh, device)
        step()  # Adam's moments come to be
        mesh.stats.reset()
        cost, mem = _measure(step, state, device, args.hbm_gib)
    finally:
        dist.destroy_process_group()

    comm = comm_inventory(mesh.stats)
    cross = sum(k["bytes_total"] for k in comm.values())
    floors_us = {
        "mxu_compute": round(1e6 * cost.flops / (args.peak_tflops * 1e12), 1),
        "hbm_bandwidth": round(1e6 * cost.bytes / (args.hbm_gbps * 1e9), 1),
        "ici_serialized": round(1e6 * cross / (args.ici_gbps * 1e9), 1),
    }
    bound = max(floors_us, key=floors_us.get)
    step_floor_s = max(floors_us.values()) / 1e6
    backend = f"fake process group of {args.devices} ranks, rank 0's step on {device}"
    if device.type != "cuda":
        backend += (" (CAVEAT: the CPU reads no device memory and chooses no cuDNN "
                    "algorithms; plan --device cuda for those)")
    return {
        "model": cfg.model,
        "geometry": f"{cfg.image_size}x{cfg.image_size} bs{cfg.batch_size} {cfg.compute_dtype}",
        "backend": backend,
        "mesh": {"shape": dict(mesh.shape), "model_axis_mode": cfg.model_axis_mode},
        "per_chip": {
            "step_flops": float(cost.flops),
            "step_hbm_bytes": float(cost.bytes),
            "cross_shard_bytes": cross,
            "memory": mem,
        },
        "cross_shard_ops": comm,
        "step_floors_us": floors_us,
        "bound": bound,
        "max_steps_per_s": round(1.0 / step_floor_s, 1) if step_floor_s else None,
        "max_images_per_s_global": (round(cfg.batch_size / step_floor_s)
                                    if step_floor_s else None),
        "note": ("Rank 0's second train step run eagerly over a fake process group. FLOPs: "
                 "torch.utils.flop_counter's registry (matmuls, convolutions) per aten op; "
                 "HBM bytes: every op's tensor operands and results, unfused, so an upper "
                 "bound where XLA's count is fused. Counts and bytes are per rank. "
                 "Cross-shard bytes are each collective's payload at the tensor's own width, "
                 "as NCCL sends it (gloo widens 16-bit floats to f32). Floors assume no "
                 "compute/comm overlap (real steps overlap, so these are upper bounds on "
                 "cost, lower bounds on throughput)."),
    }


def main(argv=None) -> int:
    print(json.dumps(plan(argv), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
