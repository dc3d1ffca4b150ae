"""The port's train step over a mesh's model axis (``--model_axis_mode tp``
and ``spatial``: ``jckx_torch/parallel/``, ``train/steps.py``) on gloo
ranks of CPU processes, against jckx's step jitted over a ``(4, 2)`` mesh
of virtual devices with the same layout, at the tiny setup (16², base
width 16, ``tp_min_dim`` 16 so every stage shards, global batch 8, f32;
z 16, K = 10).

Each case takes one step from jckx's initial weights (``params_from_jax``)
with jckx's draws injected (tests/test_torch_train_step.py's and
tests/test_torch_cgan_step.py's ``_draws``; each data index keeps its
rows), for DCGAN and CGAN, the faithful step and FusedProp, and DCGAN
under ``--remat both`` (its recompute repeats the collectives), under TP
and spatial, on ``(1, 2)`` and ``(2, 2)`` meshes. jckx's step runs as
tests/test_tensor_parallel.py:74-98 runs it (``jit_train_step`` with
``tp_state_sharding``); its spatial step with the decoded batch
constrained to ``P("data", "model", None, None)`` and the gradients pinned
replicated, as its trainer does (``jckx/train/gan_trainer.py:212-286``).

Tolerances are jckx's own for a layout against another
(tests/test_tensor_parallel.py:96-100): the losses within 1e-4, every
parameter within rtol 2e-4 / atol 2e-5, and so Adam's first moment (half
the step's gradient: the parameters of a first Adam step do not see the
gradient's scale). Every rank's gathered parameters
must be equal, and the TP state must really be sharded.
"""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from jckx.parallel import MODEL_AXIS, make_mesh as jmake_mesh, tp_state_sharding
from jckx.train.state import create_cgan_state, create_dcgan_state, geometry
from jckx.train.steps import jit_train_step
from jckx.train.steps import make_cgan_train_step as jcstep
from jckx.train.steps import make_dcgan_train_step as jstep
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.train.steps import METRIC_NAMES
from _torch_dp_child import spawn
from _torch_model_axis_child import step_cases_rank
from test_torch_cgan_step import _draws as _cgan_draws
from test_torch_train_step import N, _cfgs
from test_torch_train_step import _draws as _dcgan_draws
from torch_threads import one_torch_thread  # noqa: F401

K = 10
TINY = dict(base_width=16, tp_min_dim=16, num_classes=K)
CASES = {  # name: (conditional, config overrides)
    "dcgan": (False, {}),
    "dcgan-fused_prop": (False, dict(fused_prop=1)),
    "cgan": (True, {}),
    "cgan-fused_prop": (True, dict(fused_prop=1)),
    "dcgan-remat-both": (False, dict(remat="both")),
}
MODES = ("tp", "spatial")
SHAPES = ((1, 2), (2, 2))


def _np_draws(d) -> dict:
    return {k: None if v is None else v.numpy() for k, v in vars(d).items()}


def _jckx_step(jc, geo, conditional: bool, mode: str):
    """jckx's step over a (4, 2) mesh in ``mode``'s layout."""
    mesh = jmake_mesh((4, 2), ("data", MODEL_AXIS))
    make = jcstep if conditional else jstep
    if mode == "tp":
        return mesh, make(jc, geo), None
    repl = NamedSharding(mesh, P())
    gc = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda g: jax.lax.with_sharding_constraint(g, repl), tree)
    base = make(jc, geo, grad_constraint=gc)
    spec = NamedSharding(mesh, P("data", MODEL_AXIS, None, None))
    if conditional:
        def step(s, real, onehot):
            return base(s, jax.lax.with_sharding_constraint(real, spec), onehot)
    else:
        def step(s, real):
            return base(s, jax.lax.with_sharding_constraint(real, spec))
    return mesh, step, spec


def _case(name: str, mode: str):
    """jckx's step of the case in ``mode`` and the port's inputs for it."""
    conditional, over = CASES[name]
    jc, tc = _cfgs({**TINY, **over, "model_axis_mode": mode})
    geo = geometry(jc)
    st = (create_cgan_state if conditional else create_dcgan_state)(
        jc, jax.random.PRNGKey(1 if conditional else 0))
    which = ("cg", "cd") if conditional else ("g", "d")
    tgeo = dict(vars(geo))

    def port_sd(params, w):
        from jckx_torch.models.dcgan import GANGeometry

        return params_from_jax({k: np.asarray(v) for k, v in params.items()},
                               GANGeometry(**tgeo), w)

    rng = np.random.RandomState(11)
    real = rng.rand(N, 16, 16, 3).astype(np.float32) * 2 - 1
    onehot = np.eye(K, dtype=np.float32)[rng.randint(0, K, N)] if conditional else None
    draws = _np_draws((_cgan_draws if conditional else _dcgan_draws)(st, geo))
    case = {"geo": tgeo, "conditional": conditional, "k": K,
            "cfg": {f: getattr(tc, f) for f in vars(tc)},
            "g0": port_sd(st.params_g, which[0]), "d0": port_sd(st.params_d, which[1]),
            "real": [real], "onehot": [onehot], "draws": [draws]}
    mesh, step, _ = _jckx_step(jc, geo, conditional, mode)
    sh = tp_state_sharding(st, mesh, min_dim=jc.tp_min_dim) if mode == "tp" else None
    jitted = jit_train_step(step, mesh=mesh, donate_state=False, state_sharding=sh)
    if sh is not None:
        st = jax.device_put(st, sh)
    st, m = jitted(st, *([real] + ([onehot] if conditional else [])))
    final = {"G": port_sd(st.params_g, which[0]), "D": port_sd(st.params_d, which[1]),
             "G_mu": port_sd(st.opt_g[0].mu, which[0]), "D_mu": port_sd(st.opt_d[0].mu, which[1])}
    return case, np.array([float(m[k]) for k in METRIC_NAMES]), final


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis_step")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases, jckx_runs = {}, {}
        for name in CASES:
            for mode in MODES:
                key = f"{name}/{mode}"
                cases[key], tele, final = _case(name, mode)
                jckx_runs[key] = {"telemetry": tele, **final}
        inputs = tmp / "inputs.pt"
        torch.save({"cases": cases}, inputs)
        ranks = {}
        for shape in SHAPES:
            out = tmp / f"mesh{shape[0]}x{shape[1]}"
            out.mkdir()
            spawn(step_cases_rank, (shape, str(out / "store"), str(inputs), str(out)),
                  world=shape[0] * shape[1], timeout=240)
            ranks[shape] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                            for r in range(shape[0] * shape[1])]
    finally:
        torch.set_num_threads(before)
    return {"jckx": jckx_runs, "ranks": ranks}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_model_axis_step_matches_jckx(runs, case, mode, shape):
    key = f"{case}/{mode}"
    got, want = runs["ranks"][shape][0][key], runs["jckx"][key]
    np.testing.assert_allclose(got["telemetry"][0], want["telemetry"], rtol=0, atol=1e-4)
    for net in ("G", "D"):
        for k, v in want[net].items():
            if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
                continue
            np.testing.assert_allclose(got[net][k].numpy(), v.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=f"{key} {shape} {net}.{k}")
    for net, opt in (("G", "opt_g"), ("D", "opt_d")):  # Adam's first moment: 0.5 · gradient
        names = [k for k in want[net] if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked"))]
        for i, k in enumerate(names):
            np.testing.assert_allclose(got[opt]["state"][i]["exp_avg"].numpy(),
                                       want[f"{net}_mu"][k].numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=f"{key} {shape} {net} Adam mu of {k}")
    for other in runs["ranks"][shape][1:]:  # every rank gathers the same full state
        for net in ("G", "D"):
            for k, v in got[net].items():
                assert torch.equal(other[key][net][k], v), f"{net}.{k} differs across the ranks"
    if mode == "tp":
        assert got["sharded"], "no leaf was sharded on the model axis"
