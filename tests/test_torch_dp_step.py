"""The port's data-parallel train step (``jckx_torch/train/steps.py`` over
a process mesh, sync-BN through ``parallel/mesh.py``) on two gloo ranks of
CPU processes, at the tiny setup of tests/test_step_torch_parity.py (16²,
width 8, global batch 8, f32; z 16, K = 10).

Every case takes 3 steps from jckx's initial weights (``params_from_jax``)
with jckx's draws of each step injected (each rank keeps its rows), for
DCGAN and CGAN, the faithful step and FusedProp, and DCGAN under
``--remat both``. It is held:

- (a) across the ranks: every parameter bit-identical (the gradients and
  the telemetry are averaged over the ranks, so every rank takes the same
  Adam step);
- (b) against the port's single-rank step at the same global batch and
  draws: telemetry within 1e-5 relative (the two differ by the
  reassociation of the batch sums), and Adam deltas within 5 % of lr per
  step on all but 0.1 % of the elements where the single-rank run's last
  gradient clears 1 % of its leaf's maximum (``chip_smoke.py``'s
  ``phase_train_vs_cpu`` rule);
- (c) against jckx's step jitted over ``make_mesh((2,))`` (batch on
  ``data``, state replicated): telemetry within 3e-3 and the masked
  deltas of (b) (tests/test_torch_train_step.py's tolerances, for its
  reasons).

(d) The penalty across ranks: x̂'s gradient of Σσ(D(x̂)) runs through the
statistics of every rank, so the all-reduce sits inside autograd. The
per-row gradient norms and the penalty of the two ranks equal the
single-rank ones within 1e-5, and the penalty's second-order gradient
for D's parameters within 1e-4 of its largest; with the all-reduce
detached, the same comparison misses by far more, which the test
requires too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx.parallel import make_mesh as jmake_mesh
from jckx.train.state import create_cgan_state, create_dcgan_state, geometry
from jckx.train.steps import jit_train_step
from jckx.train.steps import make_cgan_train_step as jcstep
from jckx.train.steps import make_dcgan_train_step as jstep
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.train.steps import METRIC_NAMES
from _torch_dp_child import run_step_case, penalty_terms, spawn, step_cases_rank
from test_torch_cgan_step import K
from test_torch_cgan_step import _draws as _cgan_draws
from test_torch_train_step import LR, N, _cfgs
from test_torch_train_step import _draws as _dcgan_draws
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 3
CASES = {  # name: (conditional, config overrides)
    "dcgan": (False, {}),
    "dcgan-fused_prop": (False, dict(fused_prop=1)),
    "cgan": (True, {}),
    "cgan-fused_prop": (True, dict(fused_prop=1)),
    "dcgan-remat-both": (False, dict(remat="both")),
}


def _np_draws(d) -> dict:
    return {k: None if v is None else v.numpy() for k, v in vars(d).items()}


def _case(name):
    """jckx's run of the case over a 2-device mesh, and the case's inputs:
    → (inputs for ``run_step_case``, jckx telemetry (steps, 6), jckx's
    final params in the port's layout)."""
    conditional, over = CASES[name]
    jc, tc = _cfgs({"num_classes": K, **over})
    geo = geometry(jc)
    tgeo = dict(vars(geo))
    st = (create_cgan_state if conditional else create_dcgan_state)(
        jc, jax.random.PRNGKey(1 if conditional else 0))
    which = ("cg", "cd") if conditional else ("g", "d")

    def port_sd(params, w, buffers=True):
        from jckx_torch.models.dcgan import GANGeometry

        sd = params_from_jax({k: np.asarray(v) for k, v in params.items()}, GANGeometry(**tgeo), w)
        return {k: v for k, v in sd.items()
                if buffers or not k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked"))}

    rng = np.random.RandomState(11)
    real = [rng.rand(N, 16, 16, 3).astype(np.float32) * 2 - 1 for _ in range(STEPS)]
    onehot = [np.eye(K, dtype=np.float32)[rng.randint(0, K, N)] if conditional else None
              for _ in range(STEPS)]
    case = {"geo": tgeo, "conditional": conditional, "k": K,
            "cfg": {f: getattr(tc, f) for f in vars(tc)},
            "g0": port_sd(st.params_g, which[0]), "d0": port_sd(st.params_d, which[1]),
            "real": real, "onehot": onehot, "draws": []}
    step = jit_train_step((jcstep if conditional else jstep)(jc, geo), mesh=jmake_mesh((2,)),
                          donate_state=False)
    draws_of = _cgan_draws if conditional else _dcgan_draws
    telemetry = []
    for i in range(STEPS):
        case["draws"].append(_np_draws(draws_of(st, geo)))
        st, m = step(st, *([real[i]] + ([onehot[i]] if conditional else [])))
        telemetry.append([float(m[k]) for k in METRIC_NAMES])
    final = {"G": port_sd(st.params_g, which[0], False), "D": port_sd(st.params_d, which[1], False)}
    return case, np.array(telemetry), final


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """jckx's mesh runs, the port's single-rank runs and the port's 2-rank
    runs of every case, and the penalty's terms, computed once."""
    tmp = tmp_path_factory.mktemp("dp_step")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases, jckx_runs = {}, {}
        for name in CASES:
            cases[name], tele, final = _case(name)
            jckx_runs[name] = {"telemetry": tele, **final}
        rng = np.random.RandomState(5)
        img = (N, 16, 16, 3)
        gp = {"case": "dcgan", "alpha": rng.rand(N, 1, 1, 1).astype(np.float32),
              "real": rng.rand(*img).astype(np.float32) * 2 - 1,
              "fake": rng.rand(*img).astype(np.float32) * 2 - 1}
        single = {name: run_step_case(case) for name, case in cases.items()}
        single["gp"] = penalty_terms(cases["dcgan"], gp)
        inputs = tmp / "inputs.pt"
        torch.save({"cases": cases, "gp": gp}, inputs)
        spawn(step_cases_rank, (2, str(tmp / "store"), str(inputs), str(tmp)), timeout=180)
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    finally:
        torch.set_num_threads(before)
    return {"cases": cases, "jckx": jckx_runs, "single": single, "ranks": ranks}


def _assert_masked_deltas(start: dict, got: dict, want: dict, grads: dict, label: str) -> None:
    """Deltas from ``start`` within 5 % of lr per step where ``grads``
    clears 1 % of its leaf's maximum, on all but 0.1 % of those elements."""
    total = covered = 0
    for k, g in grads.items():
        g = np.abs(np.asarray(g))
        mask = g > 1e-2 * g.max() + 1e-12
        d_got = np.asarray(got[k]) - np.asarray(start[k])
        d_want = np.asarray(want[k]) - np.asarray(start[k])
        bad = int((np.abs(d_got - d_want) > 0.05 * LR * STEPS)[mask].sum())
        assert bad <= 1e-3 * mask.sum(), \
            f"{label}/{k}: {bad} of {int(mask.sum())} masked Adam deltas differ by > 5 % of lr"
        total += mask.size
        covered += int(mask.sum())
    assert covered / total > 0.5, f"{label}: the mask covers {covered}/{total} elements"


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_stay_bit_identical(runs, case):
    a, b = (r[case] for r in runs["ranks"])
    for net in ("G", "D"):
        for k in a[net]:
            assert torch.equal(a[net][k], b[net][k]), f"{net}.{k} differs across the ranks"
    np.testing.assert_array_equal(a["telemetry"], b["telemetry"])


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_single_rank_step(runs, case):
    dp, one, c = runs["ranks"][0][case], runs["single"][case], runs["cases"][case]
    np.testing.assert_allclose(dp["telemetry"], one["telemetry"], rtol=1e-5, atol=1e-6)
    if CASES[case][1].get("fused_prop"):
        np.testing.assert_array_equal(dp["telemetry"][:, 3], dp["telemetry"][:, 5])
    for net, start in (("G", c["g0"]), ("D", c["d0"])):
        _assert_masked_deltas(start, {k: v.numpy() for k, v in dp[net].items()},
                              {k: v.numpy() for k, v in one[net].items()},
                              {k: v.numpy() for k, v in one[f"{net}_grad"].items()},
                              f"{case} {net}")


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_jckx_on_a_two_device_mesh(runs, case):
    dp, jx, c = runs["ranks"][0][case], runs["jckx"][case], runs["cases"][case]
    np.testing.assert_allclose(dp["telemetry"], jx["telemetry"], rtol=3e-3, atol=3e-3)
    for net, start in (("G", c["g0"]), ("D", c["d0"])):
        _assert_masked_deltas(start, {k: v.numpy() for k, v in dp[net].items()},
                              {k: np.asarray(v) for k, v in jx[net].items()},
                              {k: v.numpy() for k, v in dp[f"{net}_grad"].items()},
                              f"{case} {net} vs jckx")


def _penalty_gap(dp_ranks, one) -> tuple:
    """(largest relative gap of the per-row norms, of the penalty, of the
    penalty's D gradient) between the two ranks and the single rank."""
    norms = torch.cat([r["norms"] for r in dp_ranks])
    g_norm = ((norms - one["norms"]).abs() / one["norms"].abs()).max().item()
    g_gp = abs(dp_ranks[0]["gp"] - one["gp"]) / abs(one["gp"])
    g_grad = max(((dp_ranks[0]["D_grad"][k] - v).abs().max() / v.abs().max()).item()
                 for k, v in one["D_grad"].items())
    return g_norm, g_gp, g_grad


def test_penalty_gradient_crosses_the_ranks(runs):
    """(d): the sync all-reduce inside autograd gives the single rank's
    penalty; a detached one does not, and this comparison sees it."""
    sync = [r["gp_sync"] for r in runs["ranks"]]
    assert sync[0]["gp"] == sync[1]["gp"]
    g_norm, g_gp, g_grad = _penalty_gap(sync, runs["single"]["gp"])
    assert g_norm <= 1e-5 and g_gp <= 1e-5 and g_grad <= 1e-4, (g_norm, g_gp, g_grad)
    detached = _penalty_gap([r["gp_detached"] for r in runs["ranks"]], runs["single"]["gp"])
    assert detached[0] > 1e-3 and detached[2] > 1e-3, \
        f"a detached all-reduce went unseen: {detached}"
