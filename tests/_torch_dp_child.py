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

import contextlib
import datetime
import os
import shutil
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


# ----------------------------------------------- compiled programs on a mesh

@contextlib.contextmanager
def _graphs_as_on_the_card(*modules):
    """Inside: each of ``modules`` builds its graphs as the card would over
    a capturable mesh, with the CPU's stand-in graph (this process's gloo
    mesh is not one: its collectives run on the host)."""
    from jckx_torch.utils.graphs import EagerGraph

    own = [m.graph_for for m in modules]
    for m in modules:
        m.graph_for = lambda *a, **k: (EagerGraph, "")
    try:
        yield
    finally:
        for m, f in zip(modules, own):
            m.graph_for = f


def _gan_trainer(case: dict, mesh, root: str):
    """A trainer of ``case`` (its config, weights and uint8 set, an EMA of
    0.9) over ``mesh``, with ``RenderStub`` for the metrics engine."""
    from types import SimpleNamespace

    from jckx_torch.configs import Config
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.train import gan_trainer

    cfg = Config()
    for k, v in {**case["cfg"], "device": "cpu", "log_file": 0, "eval_every": 0, "ema_decay": 0.9,
                 "sample_count": case["sample_count"], "save_root": root,
                 "save_path": root}.items():
        setattr(cfg, k, v)
    _, G, D = _nets(case)
    data = SimpleNamespace(images_u8=case["images_u8"], labels_np=case["labels"],
                           num_classes=case["k"], metric_source=None,
                           idx_to_labels={i: str(i) for i in range(case["k"])})
    MainLogger.reset()
    cls = gan_trainer.CGANTrainer if case["conditional"] else gan_trainer.DCGANTrainer
    return cls(cfg, G, D, data, metrics=RenderStub(), mesh=mesh)


def _gan_record(tr) -> dict:
    s = tr.state
    out = {f"{m}/{k}": v.detach().clone() for m, net in (("G", s.G), ("D", s.D), ("EMA", s.ema_g))
           for k, v in net.state_dict().items()}
    for name, opt in (("opt_g", s.opt_g), ("opt_d", s.opt_d)):
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}/{i}/{k}": torch.as_tensor(v).clone() for k, v in st.items()})
    return out


def _stats_delta(stats, snap) -> dict:
    """Calls, bytes, replayed calls and host seconds by kind since ``snap``."""
    return {k: (stats.calls[k] - snap["calls"][k], stats.bytes[k] - snap["bytes"][k],
                stats.replayed[k] - snap["replayed"][k], stats.seconds[k] - snap["seconds"][k])
            for k in stats.KINDS}


LAUNCH_SIZES = (1, 1, 2)  # a GAN case's steps by launch: the warm step, then replays


def _gan_launches(case: dict, mesh, root: str, graphed: bool) -> dict:
    """Four steps of ``case``'s trainer over ``mesh`` in launches of
    ``LAUNCH_SIZES`` (through the superstep when ``graphed``: the first
    step eager and captured, then replays), and two eval renders: → the
    telemetry, G, D and their gradients after each launch, the final
    state, the renders, and ``mesh.stats`` by launch and over the renders."""
    from jckx_torch.train import gan_trainer

    with _graphs_as_on_the_card(gan_trainer) if graphed else contextlib.nullcontext():
        tr = _gan_trainer(case, mesh, root)
    assert (tr.superstep is not None) == graphed and (tr.eval_program is not None) == graphed
    batches = [{"idx": torch.from_numpy(rows)} for rows in case["order"][:, mesh.rank]]
    rec = {"stats": [], "nets": [], "grads": []}
    rows, done = [], 0
    for k in LAUNCH_SIZES:
        snap = mesh.stats.snapshot()
        rows.append(tr._launch(batches[done:done + k]))
        done += k
        rec["stats"].append(_stats_delta(mesh.stats, snap))
        rec["nets"].append({net: {k: v.detach().clone()
                                  for k, v in getattr(tr.state, net).state_dict().items()}
                            for net in ("G", "D")})
        rec["grads"].append({net: {k: p.grad.clone()
                                   for k, p in getattr(tr.state, net).named_parameters()}
                             for net in ("G", "D")})
    rec["telemetry"] = torch.cat(rows)
    rec["state"], rec["step"] = _gan_record(tr), tr.state.step
    if graphed:
        rec["superstep"] = (tr.superstep.captures, tr.superstep.replays)
    snap = mesh.stats.snapshot()
    rec["renders"] = [tr.sample_eval(), tr.sample_eval()]
    rec["eval_stats"] = _stats_delta(mesh.stats, snap)
    if graphed:
        rec["eval_program"] = (tr.eval_program.captures, tr.eval_program.replays)
    return rec


def _injected_draws(table: dict):
    """``steps.make_draws`` returning the first ``n`` rows of ``table``'s
    global draws at the steps it holds (jckx's), the port's elsewhere."""
    from jckx_torch.train import steps

    own = steps.make_draws

    def make_draws(seed, step, n, geo, device, conditional=False):
        if step not in table:
            return own(seed, step, n, geo, device, conditional)
        return steps.StepDraws(**{k: None if v is None else torch.from_numpy(v[:n]).to(device)
                                  for k, v in table[step].items()})

    return make_draws


def mesh_graph_rank(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    """Over the gloo pair: each GAN case's trainer eagerly and through the
    superstep's host logic (``_gan_launches``), with jckx's draws injected
    at the steps the case holds; then ``finetune_graph_runs``."""
    from jckx_torch.train import steps

    mesh = _group(rank, world, store)
    data = torch.load(inputs, weights_only=False)
    own = steps.make_draws
    record = {}
    for name, case in data["cases"].items():
        steps.make_draws = _injected_draws(case["draws"])
        try:
            record[name] = {route: _gan_launches(case, mesh, os.path.join(out, f"{name}-{route}-{rank}"),
                                                 route == "graph")
                            for route in ("eager", "graph")}
        finally:
            steps.make_draws = own
    record["finetune"] = finetune_graph_runs(data["finetune_argv"], out, rank, mesh)
    _finish(out, rank, record)


def finetune_graph_runs(argv: list, out: str, rank: int, mesh) -> dict:
    """The fine-tune over the mesh, eagerly and through its superstep's
    host logic, the kernel wrapper counting as on the card (one launch per
    normalize pass): → each route's final weights, epochs, launches and
    ``mesh.stats`` of its run."""
    from jckx_torch.kernels import fused_bn_act as fba
    from jckx_torch.logging.main_logger import MainLogger
    from jckx_torch.metrics import inception_train
    from jckx_torch.ops import norm

    plain = norm.normalize_act_op

    def counting(*args):
        fba.add_launches(1)
        return plain(*args)

    norm.normalize_act_op = counting
    own_mesh = inception_train.process_mesh
    inception_train.process_mesh = lambda *a, **k: mesh  # its collectives counted in mesh.stats
    rec = {}
    try:
        for route in ("eager", "graph"):
            MainLogger.reset()
            fba.LAUNCHES, snap = 0, mesh.stats.snapshot()
            save_dir = os.path.join(out, f"ft-{route}-{rank}")
            with (_graphs_as_on_the_card(inception_train) if route == "graph"
                  else contextlib.nullcontext()):
                run = inception_train.train(inception_train.get_args(
                    argv + ["--save_dir", save_dir]))
            shutil.rmtree(save_dir, ignore_errors=True)  # rank 0's .npz files: ~90 MB each
            rec[route] = {"params": {k: v.detach().clone() for k, v in run.net.state_dict().items()},
                          "epochs": run.epochs, "launches": fba.LAUNCHES,
                          "stats": _stats_delta(mesh.stats, snap),
                          "superstep": None if run.superstep is None else (
                              run.superstep.captures, run.superstep.replays, run.superstep.launches)}
    finally:
        norm.normalize_act_op = plain
        inception_train.process_mesh = own_mesh
        MainLogger.reset()
    return rec


if __name__ == "__main__":
    # ``torchrun ... tests/_torch_dp_child.py <command> <args>``: one rank of
    # ``python -m jckx_torch <command> <args>``, each "{rank}" in the
    # arguments replaced by the rank (a private save root per rank)
    import sys

    from jckx_torch.__main__ import main

    sys.exit(main([a.replace("{rank}", os.environ["RANK"]) for a in sys.argv[1:]]))
