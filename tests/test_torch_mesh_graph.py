"""The port's compiled programs over a process mesh (``utils/graphs.py``'s
``graph_for`` over a ``ProcessMesh``, the superstep, the eval sampler and
the fine-tune's superstep with the mesh's collectives inside) on the CPU:
two gloo ranks (tests/_torch_dp_child.py's ``spawn``) whose trainers build
their graphs as the card would over a NCCL mesh, with ``EagerGraph``, the
stand-in that re-runs the captured callable on the static inputs (the
card's capture is held in tests/test_torch_gpu.py and chip_smoke.py's
``phase_mesh_graph``). The tiny setup of tests/test_step_torch_parity.py:
16², width 8, global batch 8 (4 rows a rank), f32, z 16, K = 10.

- (a) ``graph_for``'s route over a NCCL mesh, a mesh with no process
  group, gloo, a local mesh, a model axis of 2, ``--sanitize`` and the CPU.
- (b) DCGAN and CGAN trainers over the pair, 4 steps launched as 1 + 1 +
  2 (through the superstep: the first step eager and captured, then 3
  replays), from jckx's initial weights with jckx's draws of the first two
  steps injected: on every rank the superstep's route equals the eager
  route bit for bit (telemetry, G, D, the EMA, Adam), and its first step
  and its first replayed step match jckx's step jitted over a two-device
  mesh by tests/test_torch_dp_step.py's criteria (telemetry within 3e-3,
  masked Adam deltas within 5 % of lr per step). A feed that drew the local
  batch would hand both ranks other rows of the global draws.
- (c) The fine-tune over the pair through its superstep equals its eager
  run bit for bit, with 94 kernel launches per step either way.
- (d) The eval sampler's graph (the rank's rows, sync-BN, the ordered
  gather) renders what the eager sampler renders, bit for bit.
- (e) After k replays ``mesh.stats`` holds k times the eager step's calls
  and bytes by kind, marked as replayed, with no host seconds.
"""

import shutil

import numpy as np
import jax
import pytest
import torch

from jckx.parallel import make_mesh as jmake_mesh
from jckx.train.state import create_cgan_state, create_dcgan_state, geometry
from jckx.train.steps import jit_train_step
from jckx.train.steps import make_cgan_train_step as jcstep
from jckx.train.steps import make_dcgan_train_step as jstep
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.data.pipeline import decode_batch
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.parallel.mesh import ProcessMesh, make_mesh
from jckx_torch.train.steps import METRIC_NAMES
from jckx_torch.utils.graphs import CudaGraph, graph_for
from _torch_dp_child import LAUNCH_SIZES, mesh_graph_rank, spawn
from test_torch_cgan_step import K
from test_torch_cgan_step import _draws as _cgan_draws
from test_torch_train_step import LR, N, _cfgs
from test_torch_train_step import _draws as _dcgan_draws
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 4      # launched as LAUNCH_SIZES
JCKX_STEPS = 2  # compared with jckx: the eager first step and the first replay
ROWS = 32
FT_STEPS = 3
FT_CONVS = 94  # normalize passes of one fine-tune step


def _mesh(shape=(1,), axes=("data",), backend=None):
    """A process mesh with no process group, told it runs on ``backend``."""
    mesh = ProcessMesh(shape, axes)
    mesh.backend = backend
    return mesh


def test_graph_for_routes_over_meshes():
    cuda = torch.device("cuda", 0)
    for mesh in (_mesh(backend="nccl"), _mesh(), _mesh((8,), backend="nccl")):
        assert graph_for(cuda, False, mesh) == (CudaGraph, "")
    for args, why in (
            ((cuda, False, _mesh(backend="gloo")), "gloo collectives run on the host"),
            ((cuda, False, make_mesh(devices=["cpu", "cpu"])), "local mesh"),
            ((cuda, False, _mesh((1, 2), ("data", "model"), "nccl")), "model axis of 2"),
            ((cuda, True, _mesh(backend="nccl")), "--sanitize"),
            ((torch.device("cpu"), False, _mesh(backend="nccl")), "CUDA graphs need the card"),
            ((cuda, False, object()), "on a mesh")):
        graph, reason = graph_for(*args)
        assert graph is None and why in reason, reason


def _np_draws(d) -> dict:
    return {k: None if v is None else v.numpy() for k, v in vars(d).items()}


def _case(conditional: bool):
    """A uint8 set, the global batches of 4 steps (each split into the two
    ranks' rows) and jckx's weights, and jckx's first two steps on those
    batches over a two-device mesh: → (the case for the ranks, jckx's
    telemetry and G / D after each of its steps, in the port's layout)."""
    jc, tc = _cfgs({"num_classes": K})
    geo = geometry(jc)
    tgeo = dict(vars(geo))
    st = (create_cgan_state if conditional else create_dcgan_state)(
        jc, jax.random.PRNGKey(1 if conditional else 0))
    which = ("cg", "cd") if conditional else ("g", "d")

    def port_sd(params, w, buffers=True):
        sd = params_from_jax({k: np.asarray(v) for k, v in params.items()}, GANGeometry(**tgeo), w)
        return {k: v for k, v in sd.items()
                if buffers or not k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked"))}

    rng = np.random.RandomState(13 + conditional)
    images = rng.randint(0, 256, (ROWS, 16, 16, 3)).astype(np.uint8)
    labels = rng.randint(0, K, ROWS).astype(np.int64)
    order = rng.permutation(ROWS)[:STEPS * N].reshape(STEPS, N)
    case = {"geo": tgeo, "conditional": conditional, "k": K,
            "cfg": {f: getattr(tc, f) for f in vars(tc)}, "sample_count": 8,
            "g0": port_sd(st.params_g, which[0]), "d0": port_sd(st.params_d, which[1]),
            "images_u8": images, "labels": labels, "order": order.reshape(STEPS, 2, N // 2),
            "draws": {}}
    step = jit_train_step((jcstep if conditional else jstep)(jc, geo), mesh=jmake_mesh((2,)),
                          donate_state=False)
    draws_of = _cgan_draws if conditional else _dcgan_draws
    ref = {"telemetry": [], "params": []}
    for s in range(JCKX_STEPS):
        real = decode_batch(torch.from_numpy(images[order[s]]), 16).numpy()
        onehot = [np.eye(K, dtype=np.float32)[labels[order[s]]]] if conditional else []
        case["draws"][s] = _np_draws(draws_of(st, geo))
        st, m = step(st, real, *onehot)
        ref["telemetry"].append([float(m[k]) for k in METRIC_NAMES])
        ref["params"].append({"G": port_sd(st.params_g, which[0], False),
                              "D": port_sd(st.params_d, which[1], False)})
    return case, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """jckx's runs of both cases and the pair's eager and graphed runs of
    every case and of the fine-tune, computed once."""
    tmp = tmp_path_factory.mktemp("mesh_graph")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases, jckx_runs = {}, {}
        for name, conditional in (("dcgan", False), ("cgan", True)):
            cases[name], jckx_runs[name] = _case(conditional)
        ft_argv = ["--device", "cpu", "--dataset", "synthetic", "--synthetic_size", "32",
                   "-b", "8", "-e", "1", "--max_steps_per_epoch", str(FT_STEPS),
                   "--scan_steps", "2", "--image_size", "75", "--compute_dtype", "float32",
                   "-mlr", "0.01", "--eval_samples", "6", "--data_dir", str(tmp / "data"),
                   "--mesh_shape", "2"]
        inputs = tmp / "inputs.pt"
        torch.save({"cases": cases, "finetune_argv": ft_argv}, inputs)
        spawn(mesh_graph_rank, (2, str(tmp / "store"), str(inputs), str(tmp)), timeout=240)
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    finally:
        torch.set_num_threads(before)
        shutil.rmtree(tmp, ignore_errors=True)  # the ranks' records: ~185 MB each
    return {"cases": cases, "jckx": jckx_runs, "ranks": ranks}


def _assert_equal(a: dict, b: dict, label: str) -> None:
    assert a.keys() == b.keys(), label
    for k in a:
        assert torch.equal(a[k], b[k]), f"{label}: {k}"


@pytest.mark.parametrize("case", ["dcgan", "cgan"])
def test_superstep_pair_equals_the_eager_pair(runs, case):
    for r, rank in enumerate(runs["ranks"]):
        eager, graph = rank[case]["eager"], rank[case]["graph"]
        assert graph["superstep"] == (1, STEPS - 1) and graph["step"] == eager["step"] == STEPS
        assert torch.equal(graph["telemetry"], eager["telemetry"]), f"rank {r}"
        _assert_equal(graph["state"], eager["state"], f"{case} rank {r}")
    _assert_equal(runs["ranks"][0][case]["graph"]["state"],
                  runs["ranks"][1][case]["graph"]["state"], f"{case} across the ranks")


def _assert_masked_deltas(start: dict, got: dict, want: dict, grads: dict, steps: int,
                          label: str) -> None:
    """tests/test_torch_dp_step.py's rule: deltas from ``start`` within 5 %
    of lr per step where ``grads`` clears 1 % of its leaf's maximum, on all
    but 0.1 % of those elements."""
    total = covered = 0
    for k, g in grads.items():
        g = np.abs(g.numpy())
        mask = g > 1e-2 * g.max() + 1e-12
        d_got = got[k].numpy() - start[k].numpy()
        d_want = np.asarray(want[k]) - start[k].numpy()
        bad = int((np.abs(d_got - d_want) > 0.05 * LR * steps)[mask].sum())
        assert bad <= 1e-3 * mask.sum(), \
            f"{label}/{k}: {bad} of {int(mask.sum())} masked Adam deltas differ by > 5 % of lr"
        total += mask.size
        covered += int(mask.sum())
    assert covered / total > 0.5, f"{label}: the mask covers {covered}/{total} elements"


@pytest.mark.parametrize("case", ["dcgan", "cgan"])
def test_superstep_pair_matches_jckx_on_a_two_device_mesh(runs, case):
    """The first step (the eager warm step) and the second (the first
    replay, whose draws the feed made) against jckx's."""
    graph, ref, c = runs["ranks"][0][case]["graph"], runs["jckx"][case], runs["cases"][case]
    np.testing.assert_allclose(graph["telemetry"][:JCKX_STEPS].numpy(), ref["telemetry"],
                               rtol=3e-3, atol=3e-3)
    for s in range(JCKX_STEPS):
        for net, start in (("G", c["g0"]), ("D", c["d0"])):
            _assert_masked_deltas(start, graph["nets"][s][net], ref["params"][s][net],
                                  graph["grads"][s][net], s + 1, f"{case} step {s + 1} {net}")


def test_finetune_superstep_pair_equals_the_eager_pair(runs):
    for r, rank in enumerate(runs["ranks"]):
        eager, graph = rank["finetune"]["eager"], rank["finetune"]["graph"]
        assert eager["superstep"] is None and graph["superstep"] == (1, FT_STEPS - 1, FT_CONVS)
        _assert_equal(graph["params"], eager["params"], f"fine-tune rank {r}")
        for ea, eb in zip(eager["epochs"], graph["epochs"]):
            for k in ("steps", "train_loss", "train_acc", "top1", "loss"):
                assert ea[k] == eb[k], k
        assert eager["launches"] == graph["launches"] == FT_CONVS * FT_STEPS


@pytest.mark.parametrize("case", ["dcgan", "cgan"])
def test_graphed_eval_sampler_pair_equals_the_eager_one(runs, case):
    for rank in runs["ranks"]:
        eager, graph = rank[case]["eager"], rank[case]["graph"]
        assert graph["eval_program"] == (1, 1)  # the warm call, then a replay
        for got in graph["renders"]:
            assert torch.equal(got, eager["renders"][0])
        assert torch.equal(eager["renders"][1], eager["renders"][0])
    assert torch.equal(runs["ranks"][1][case]["graph"]["renders"][1],
                       runs["ranks"][0][case]["graph"]["renders"][1])


@pytest.mark.parametrize("case", ["dcgan", "cgan", "finetune"])
def test_replays_count_their_collectives(runs, case):
    for rank in runs["ranks"]:
        if case == "finetune":
            eager, graph = (rank["finetune"][r]["stats"] for r in ("eager", "graph"))
            reduces = eager["all_reduce"][0]
            assert reduces % FT_STEPS == 0 and reduces > 0
            for kind, (calls, nbytes, replayed, _) in graph.items():
                assert (calls, nbytes) == eager[kind][:2], kind
            assert graph["all_reduce"][2] == reduces // FT_STEPS * (FT_STEPS - 1)
            continue
        eager, graph = rank[case]["eager"], rank[case]["graph"]
        one = eager["stats"][0]  # the eager step's collectives
        assert one["all_reduce"][0] > 0
        for kind, (calls, nbytes, _, _) in one.items():
            assert graph["stats"][0][kind][:3] == (calls, nbytes, 0), kind  # the warm step
            for i, k in enumerate(LAUNCH_SIZES):
                assert eager["stats"][i][kind][:3] == (k * calls, k * nbytes, 0), kind
                if i:
                    assert graph["stats"][i][kind] == (k * calls, k * nbytes, k * calls, 0.0), kind
        render = eager["eval_stats"]
        assert render["all_gather"][0] == 2 and render["all_reduce"][0] > 0
        for kind, (calls, nbytes, replayed, _) in render.items():
            assert graph["eval_stats"][kind][:3] == (calls, nbytes, calls // 2), kind
