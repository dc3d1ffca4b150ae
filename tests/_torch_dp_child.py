"""Children of the port's data-parallel CPU tests: each function runs in one
rank of a gloo process group that ``spawn`` starts, imports only torch and
``jckx_torch``, and writes what it computed to ``<out>/rank<r>.pt`` for the
parent test to compare.

The group meets through a ``file://`` store under the test's ``tmp_path``
(six test workers run at once: no fixed port), every collective times out
after ``COLLECTIVE_TIMEOUT`` seconds, and ``spawn`` kills the children and
fails after its own timeout, so a rank that skips a collective fails the
test instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT = 60


def spawn(fn, args: tuple, world: int = 2, timeout: float = 120.0) -> None:
    """``fn(rank, *args)`` in ``world`` spawned processes; raises when one
    raises or when they are not done within ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(fn, args=args, nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: the ranks did not finish within {timeout} s")


def _group(rank: int, world: int, store: str):
    """One thread, the gloo group over the file store, the process mesh."""
    from jckx_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    return make_mesh((world,), device="cpu")


def _finish(out: str, rank: int, record: dict) -> None:
    torch.save(record, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------ train steps

def _nets(case: dict):
    from jckx_torch.models import cgan as tcgan
    from jckx_torch.models import dcgan as tdcgan

    geo = tdcgan.GANGeometry(**case["geo"])
    if case["conditional"]:
        G, D = tcgan.CGenerator(geo, case["k"]), tcgan.CDiscriminator(geo, case["k"])
    else:
        G, D = tdcgan.Generator(geo), tdcgan.Discriminator(geo)
    G.load_state_dict(case["g0"])
    D.load_state_dict(case["d0"])
    return geo, G, D


def run_step_case(case: dict, mesh=None) -> dict:
    """The port's train step on ``case`` (weights, batches, the global
    draws of every step): over ``mesh`` each rank steps on its rows. →
    the telemetry of every step and the final parameters and gradients."""
    from jckx_torch.configs import Config
    from jckx_torch.train import state as tstate
    from jckx_torch.train.steps import (METRIC_NAMES, StepDraws, make_cgan_train_step,
                                        make_dcgan_train_step, shard_draws)

    cfg = Config()
    for k, v in case["cfg"].items():
        setattr(cfg, k, v)
    geo, G, D = _nets(case)
    ts = tstate.create_dcgan_state(cfg, G, D)
    make = make_cgan_train_step if case["conditional"] else make_dcgan_train_step
    step = make(cfg, geo, mesh)
    rows = (lambda t: t) if mesh is None else mesh.rows
    telemetry = []
    for real, onehot, draws in zip(case["real"], case["onehot"], case["draws"]):
        d = shard_draws(StepDraws(**{k: None if v is None else torch.from_numpy(v)
                                     for k, v in draws.items()}), mesh)
        args = (rows(torch.from_numpy(real)),)
        if case["conditional"]:
            args += (rows(torch.from_numpy(onehot)),)
        m = step(ts, *args, d)
        telemetry.append([float(m[k]) for k in METRIC_NAMES])
    return {"telemetry": np.array(telemetry),
            "G": {k: v.detach().clone() for k, v in G.state_dict().items()},
            "D": {k: v.detach().clone() for k, v in D.state_dict().items()},
            "G_grad": {k: p.grad.clone() for k, p in G.named_parameters()},
            "D_grad": {k: p.grad.clone() for k, p in D.named_parameters()}}


def penalty_terms(case: dict, inputs: dict, mesh=None) -> dict:
    """WGAN-GP's pieces at the case's initial D with sync BN: x̂'s gradient
    of Σσ(D(x̂)) (per-row norms), the penalty, and the penalty's gradient
    for D's parameters (second order, averaged over the ranks)."""
    rows = (lambda t: t) if mesh is None else mesh.rows
    _, _, D = _nets(case)
    alpha, real, fake = (rows(torch.from_numpy(inputs[k])) for k in ("alpha", "real", "fake"))
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sigmoid(D(interp, mesh=mesh)).sum(), interp,
                               create_graph=True)
    norms = torch.sqrt((g.reshape(g.shape[0], -1) ** 2).sum(1) + 1e-24)
    gp = torch.mean((norms - 1.0) ** 2)
    gp.backward()
    if mesh is not None:
        mesh.average_grads(D.parameters())
        gp = mesh.mean(gp)
    return {"norms": norms.detach(), "gp": float(gp),
            "D_grad": {k: p.grad.clone() for k, p in D.named_parameters()}}


def step_cases_rank(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    """Every case of ``inputs`` over the mesh, then the penalty's terms,
    sync and detached (the statistics' all-reduce taken outside autograd,
    the fault the penalty test must catch)."""
    from jckx_torch.parallel.mesh import ProcessMesh

    mesh = _group(rank, world, store)
    data = torch.load(inputs, weights_only=False)
    record = {name: run_step_case(case, mesh) for name, case in data["cases"].items()}
    gp_case = data["cases"][data["gp"]["case"]]
    record["gp_sync"] = penalty_terms(gp_case, data["gp"], mesh)
    sync = ProcessMesh.all_reduce

    def detached(self, t, axis="data"):
        return sync(self, t.detach(), axis)

    ProcessMesh.all_reduce = detached
    try:
        record["gp_detached"] = penalty_terms(gp_case, data["gp"], mesh)
    finally:
        ProcessMesh.all_reduce = sync
    _finish(out, rank, record)


# ---------------------------------------------------- metrics and fine-tune

def eval_features(data: dict, cache_dir: str, mesh=None) -> dict:
    """The eval protocol of ``evaluate`` on ``data``: G's renders of the
    eval inputs (``sample_eval_images``, sync-BN over ``mesh``), the real
    set's features (a host array, through the slab path) and the renders'
    features (a device tensor), by the metrics engine over ``mesh``."""
    from jckx_torch.metrics import inception_v3
    from jckx_torch.metrics.metrics import Metrics
    from jckx_torch.models.dcgan import GANGeometry, Generator
    from jckx_torch.train.gan_trainer import sample_eval_images

    G = Generator(GANGeometry(**data["geo"]), gen=torch.Generator().manual_seed(3))
    renders = sample_eval_images(G, torch.from_numpy(data["z"]), None, torch.float32, mesh)
    m = Metrics((data["real"], data["labels"]), None, backbone=inception_v3.init(0, 10),
                batch_size=data["batch_size"], compute_dtype=torch.float32, cache_dir=cache_dir,
                num_classes=10, device="cpu", mesh=mesh)
    return {"renders": renders, "real": m.real_features, "fake": m.extract_features(renders),
            "cache": sorted(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else []}


def features_rank(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    mesh = _group(rank, world, store)
    data = torch.load(inputs, weights_only=False)
    _finish(out, rank, eval_features(data, os.path.join(out, f"cache{rank}"), mesh))


def finetune_rank(rank: int, world: int, store: str, argv: list, out: str) -> None:
    """``python -m jckx_torch finetune``'s ``train`` over the mesh; each rank
    writes into its own save dir. → the final weights."""
    from jckx_torch.metrics import inception_train

    _group(rank, world, store)
    args = inception_train.get_args(argv + ["--save_dir", os.path.join(out, f"save{rank}")])
    run = inception_train.train(args)
    _finish(out, rank, {"params": {k: v.detach().clone() for k, v in run.net.state_dict().items()},
                        "epochs": run.epochs})


class RenderStub:
    """A metrics engine whose features are the renders' pixels (8 of each
    image), so the logged FID / IS / intra-FID follow the eval renders
    without InceptionV3."""

    def extract_features(self, images):
        return images.reshape(images.shape[0], -1)[:, :8].float().cpu().numpy()

    def inception_score(self, images=None, splits=10, logits=None):
        return float(np.abs(logits).mean())

    def fid(self, images_tanh=None, intra_fid=False, label=0, features=None):
        return float(features.mean())

    def intra_fid(self, images_tanh=None, features=None):
        return float(features.std())


def train_rank(rank: int, world: int, store: str, argv: list, out: str) -> None:
    """``jckx_torch.train.main.run`` over the mesh with ``RenderStub``
    metrics; "{rank}" in ``argv`` is replaced by the rank."""
    from jckx_torch.configs import get_arg_parse
    from jckx_torch.train import main as tmain

    _group(rank, world, store)
    tmain.run(get_arg_parse([a.replace("{rank}", str(rank)) for a in argv]), metrics=RenderStub())
    _finish(out, rank, {})


if __name__ == "__main__":
    # ``torchrun ... tests/_torch_dp_child.py <command> <args>``: one rank of
    # ``python -m jckx_torch <command> <args>``, each "{rank}" in the
    # arguments replaced by the rank (a private save root per rank)
    import sys

    from jckx_torch.__main__ import main

    sys.exit(main([a.replace("{rank}", os.environ["RANK"]) for a in sys.argv[1:]]))
