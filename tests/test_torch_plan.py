"""The port's capacity planner (``jckx_torch/plan.py``, ``utils/comm.py``,
``utils/cost.py``) on the CPU, against ``jckx.plan`` and a real gloo pair.

- jckx's five contracts (tests/test_plan.py:22-74) on jckx's toy argv plus
  ``--device cpu``, and the refusals: a TPU topology (naming jckx.plan), a
  mesh that is not ``--devices``, a card that is not there, a process
  group that already exists;
- the report's key sets equal jckx's on the same argv;
- the inventory over the fake process group equals the mesh's counts on a
  real gloo pair running the trainer's step (calls, bytes and wire dtypes
  per kind) at 16², width 8 (``--tp_min_dim 8``: every stage sharded),
  global batch 8, f32: TP 12 all-gathers / 12 reduce-scatters / 4
  all-reduces, spatial 28 all-reduces / 5 + 5 / 22 collective-permutes,
  and data parallel on a (2, 1) mesh;
- FLOPs of the unsharded f32 step at jckx's reference width (64², base
  width 64) within 25 % of jckx's XLA count on the same argv, at batch 8
  (both counts are linear in the batch: convolutions and matmuls here,
  every op there; measured 1.1425, 2.8163e10 against 2.4650e10);
- ``StepCost`` through ``--remat both`` (the recompute adds FLOPs) and
  FusedProp (one D forward fewer).

Collective counts are not compared with jckx's: GSPMD fuses and picks its
own collectives, where the port's are explicit calls.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dp_child import spawn
from _torch_model_axis_child import plan_stats_rank
from torch_threads import one_torch_thread  # noqa: F401


def _plan(argv):
    from jckx_torch.plan import plan

    return plan(argv)


def _toy(extra=()):
    return ["--topology", "", "--devices", "8",
            "--image_size", "16", "-b", "16", "--base_width", "16",
            "--tp_min_dim", "16", "--dataset", "synthetic", "--device", "cpu",
            *extra]


def test_plan_dp_report_contract():
    r = _plan(_toy(["-m", "DCGAN"]))
    assert r["model"] == "DCGAN"
    assert r["mesh"]["shape"] == {"data": 8}
    assert r["per_chip"]["step_flops"] > 0
    assert r["per_chip"]["step_hbm_bytes"] > 0
    assert "all-reduce" in r["cross_shard_ops"]  # data parallelism syncs gradients
    assert r["bound"] in r["step_floors_us"]
    assert r["max_images_per_s_global"] > 0
    assert "CAVEAT" in r["backend"]
    json.dumps(r)
    assert not dist.is_initialized()  # the fake group is gone


def test_plan_tp_shards_state_and_cgan_parses():
    r = _plan(_toy(["-m", "CGAN", "--mesh_shape", "4,2", "--mesh_axes", "data,model",
                    "--model_axis_mode", "tp"]))
    assert r["model"] == "CGAN"
    assert r["mesh"]["shape"] == {"data": 4, "model": 2}
    assert r["per_chip"]["cross_shard_bytes"] > 0
    assert {"all-gather", "reduce-scatter"} <= set(r["cross_shard_ops"])


def test_plan_mesh_size_mismatch_fails_loudly():
    with pytest.raises(SystemExit, match="devices"):
        _plan(_toy(["--mesh_shape", "4,4"]))
    assert not dist.is_initialized()


def test_plan_memory_fits_toy():
    mem = _plan(_toy())["per_chip"]["memory"]
    if "error" not in mem:
        assert mem["fits"] and mem["peak_mb"] < mem["hbm_mb"]
        assert mem["peak_mb"] > 0
    else:  # the CPU has no allocator statistics to read
        assert "plan --device cuda" in mem["error"]


def test_plan_floors_scale_with_overrides():
    a = _plan(_toy())
    b = _plan(_toy(["--hbm_gbps", str(3350.0 / 2)]))
    np.testing.assert_allclose(b["step_floors_us"]["hbm_bandwidth"],
                               2 * a["step_floors_us"]["hbm_bandwidth"], atol=0.25)
    assert b["per_chip"]["step_hbm_bytes"] == a["per_chip"]["step_hbm_bytes"]


def test_plan_refuses_a_tpu_topology_a_missing_card_and_a_live_group(tmp_path):
    with pytest.raises(SystemExit, match=r"jckx\.plan"):
        _plan(_toy(["--topology", "v5e:2x4"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _plan(_toy(["--device", "cuda"]))
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(SystemExit, match="already initialized"):
            _plan(_toy())
    finally:
        dist.destroy_process_group()


def test_plan_cli_prints_one_report(capsys):
    from jckx_torch.__main__ import main as cli

    assert cli(["plan", *_toy(["--mesh_shape", "4,2", "--mesh_axes", "data,model",
                               "--model_axis_mode", "spatial"])]) == 0
    r = json.loads(capsys.readouterr().out)
    assert r["mesh"] == {"shape": {"data": 4, "model": 2}, "model_axis_mode": "spatial"}
    assert r["cross_shard_ops"]["collective-permute"]["count"] > 0


def _schema(report):
    """The report's key sets, level by level (an op's entry by its keys)."""
    ops = report["cross_shard_ops"].values()
    return {"top": set(report), "mesh": set(report["mesh"]), "per_chip": set(report["per_chip"]),
            "floors": set(report["step_floors_us"]),
            "op": {tuple(sorted(v)) for v in ops},
            "dtype": {tuple(sorted(d)) for v in ops for d in v["by_dtype"].values()}}


@pytest.mark.parametrize("extra", [[], ["-m", "CGAN", "--mesh_shape", "4,2", "--mesh_axes",
                                        "data,model", "--model_axis_mode", "tp"]],
                         ids=["dp", "cgan-tp"])
def test_plan_report_has_jckx_keys(extra):
    from jckx.plan import plan as jplan

    argv = _toy(extra)
    mine = _plan(argv)
    theirs = jplan([a for a in argv if a not in ("--device", "cpu")])
    assert _schema(mine) == _schema(theirs)
    assert set(mine["cross_shard_ops"]) <= {"all-reduce", "all-gather", "reduce-scatter",
                                            "collective-permute", "all-to-all"}


TINY = dict(image_size=16, batch_size=8, base_width=8, tp_min_dim=8, compute_dtype="float32")
PAIRS = {  # name: (mesh shape, config fields, the counts every stage sharded gives)
    "tp": ((1, 2), dict(model_axis_mode="tp"),
           {"all-gather": 12, "reduce-scatter": 12, "all-reduce": 4}),
    "spatial": ((1, 2), dict(model_axis_mode="spatial"),
                {"all-reduce": 28, "all-gather": 5, "reduce-scatter": 5,
                 "collective-permute": 22}),
    "dp": ((2, 1), {}, None),
}


@pytest.fixture(scope="module")
def gloo_pair(tmp_path_factory):
    out = tmp_path_factory.mktemp("plan_gloo")
    cases = {name: (shape, {**TINY, **fields}) for name, (shape, fields, _) in PAIRS.items()}
    spawn(plan_stats_rank, ((1, 2), str(out / "store"), cases, str(out)), world=2, timeout=240)
    return torch.load(out / "rank0.pt", weights_only=False)


@pytest.mark.parametrize("name", list(PAIRS))
def test_plan_inventory_equals_a_gloo_pair(gloo_pair, name):
    from jckx_torch.utils.comm import HLO_OPS

    shape, fields, counts = PAIRS[name]
    argv = ["--devices", "2", "--mesh_shape", ",".join(map(str, shape)),
            "--mesh_axes", "data,model", "--image_size", "16", "-b", "8", "--base_width", "8",
            "--tp_min_dim", "8", "--compute_dtype", "float32", "--dataset", "synthetic",
            "--device", "cpu"] + [a for k, v in fields.items() for a in (f"--{k}", v)]
    ops = _plan(argv)["cross_shard_ops"]
    got = gloo_pair[name]
    want = {HLO_OPS[k]: (n, got["bytes"][k]) for k, n in got["calls"].items() if n}
    assert {op: (v["count"], v["bytes_total"]) for op, v in ops.items()} == want
    assert all(list(v["by_dtype"]) == ["f32"] for v in ops.values())
    assert all(d == ["torch.float32"] for k, d in got["dtypes"].items() if got["calls"][k])
    if counts is not None:
        assert {op: v["count"] for op, v in ops.items()} == counts
    else:  # data parallel: sync-BN's statistics, the two gradient buffers, the telemetry
        assert set(ops) == {"all-reduce"} and ops["all-reduce"]["count"] > 3


def test_plan_flops_within_a_quarter_of_jckx_at_reference_width():
    from jckx.plan import plan as jplan

    argv = ["--topology", "", "--devices", "1", "--image_size", "64", "-b", "8",
            "--base_width", "64", "--compute_dtype", "float32", "--dataset", "synthetic"]
    mine = _plan(argv + ["--device", "cpu"])["per_chip"]["step_flops"]
    theirs = jplan(argv)["per_chip"]["step_flops"]
    assert 0.75 <= mine / theirs <= 1.25, (mine, theirs)


def test_step_cost_holds_through_remat_and_fused_prop():
    def flops(extra):
        r = _plan(["--devices", "1", "--image_size", "16", "-b", "8", "--base_width", "8",
                   "--compute_dtype", "float32", "--dataset", "synthetic", "--device", "cpu",
                   *extra])
        return r["per_chip"]["step_flops"], r["per_chip"]["step_hbm_bytes"]

    base, remat, fused = flops([]), flops(["--remat", "both"]), flops(["--fused_prop", "1"])
    assert remat[0] > base[0] and remat[1] > base[1]  # the recompute's forwards
    assert fused[0] < base[0]  # one fake-side D forward serves both players
