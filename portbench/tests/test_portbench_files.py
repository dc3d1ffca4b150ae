"""BENCHMARK.json against the files it names, every configuration, cell,
traffic kind and metric reader loading, a new cell added as a file alone,
and a new family (``toy_family/``) added as files alone."""

import json
import math
import re
import shutil
import time

from portbench import core
from conftest import make_tiny_root, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = core.load_json(core.ROOT.parent / "BENCHMARK.json")
TOY = core.ROOT / "tests" / "toy_family"


def test_benchmark_json_follows_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"][1] == "portbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = core.load_json(core.ROOT.parent / c["file"])
        assert f["name"] == c["name"] and f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert 1 <= len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        wl, cfg = core.load_cell(w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        e2e = core.cell_metrics(SPEC, "end_to_end", w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert core.cell_metrics(SPEC, "per_layer", w["name"])
    e2e_names = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e_names and "\n" not in m["layer"]
        assert callable(core.reader(m["name"]))
        for cell in m["workloads"]:  # each such cell reports the metric it moves
            assert m["moves"] in {e["name"] for e in core.cell_metrics(SPEC, "end_to_end", cell)}
    assert len(json.dumps(SPEC)) < 64 * 1024


def check_cells(root):
    """Every cell under ``root`` loads: its traffic kind (``run``,
    ``readings``, ``REPLAYED_STEPS``), its configuration's ``params`` as its
    family's reference counts them, its limits."""
    for path in sorted((root / "workloads").glob("*.json")):
        wl, cfg = core.load_cell(path.stem, root)
        mod = core.traffic(wl["traffic"], root)
        assert callable(mod.run) and callable(mod.readings)
        assert isinstance(mod.REPLAYED_STEPS, bool)
        shapes = core.reference(cfg, root).param_shapes(cfg)
        assert {net: sum(math.prod(s) for s in named.values())
                for net, named in shapes.items()} == cfg["params"], path.stem
        assert wl["limits"], path.stem


def test_every_configuration_cell_and_reader_loads():
    check_cells(core.ROOT)
    for path in sorted((core.ROOT / "layer_metrics").glob("[!_]*.py")):
        assert callable(core.reader(path.stem))


def test_published_parameter_counts():
    counts = {}
    for name in ("dcgan-64", "cgan-64"):
        cfg = core.load_json(core.ROOT / "configs" / f"{name}.json")
        counts[name] = cfg["params"]
    assert counts == {"dcgan-64": {"g": 3_576_704, "d": 2_765_696},
                      "cgan-64": {"g": 4_395_904, "d": 4_926_569}}


def test_a_new_cell_is_a_file_only(tiny_root):
    """A workload file added beside the others is found and runs, with no
    file of the harness changed."""
    src = tiny_root / "workloads" / "dcgan-64.train.json"
    new = tiny_root / "workloads" / "dcgan-64.train-again.json"
    shutil.copy(src, new)
    wl = json.loads(new.read_text())
    wl["name"] = "dcgan-64.train-again"
    new.write_text(json.dumps(wl))
    assert core.load_cell("dcgan-64.train-again", tiny_root)[0]["name"] == "dcgan-64.train-again"
    spec = json.loads(json.dumps(SPEC))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "dcgan-64.train" in m.get("workloads", []):
            m["workloads"].append("dcgan-64.train-again")
    line, _ = core.run_cell("dcgan-64.train-again", 5, 0.3, False, "cpu", time.perf_counter(),
                            spec, tiny_root)
    assert line["correct"] and set(line["metrics"]) == {"train_img_s", "setup_s"}
    assert list(line)[-1] == "checks"


def test_a_new_family_is_files_only(scratch):
    """A family with none of the GAN keys (a two-layer classifier: its
    configuration, reference, traffic kind and cell) beside the present
    files: the tiny root builds, the toy's files pass the checks of every
    configuration, its cell runs correct with its metrics, and the GAN
    cells in the same root stay correct."""
    src = scratch / "src"
    for folder in ("configs", "workloads"):
        shutil.copytree(core.ROOT / folder, src / folder)
    shutil.copytree(TOY, src, dirs_exist_ok=True)
    root = make_tiny_root(scratch / "root", source=src)
    cfg = core.load_cell("toy-mlp.fit", root)[1]
    assert not set(cfg) & {"z_dim", "conditional", "base_width", "train", "serve"}
    check_cells(src)
    check_cells(root)
    spec = json.loads(json.dumps(SPEC))
    for m in spec["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("toy-mlp.fit")
    line, _ = core.run_cell("toy-mlp.fit", 2 ** 31 + 5, 0.3, False, "cpu", time.perf_counter(),
                            spec, root)
    assert line["correct"] and set(line["metrics"]) == {"train_img_s", "setup_s"}
    for w in SPEC["workloads"]:
        assert run_tiny(root, w["name"])[0]["correct"], w["name"]


def test_the_result_line_of_a_cell(tiny_root):
    line, err = run_tiny(tiny_root, "cgan-64.serve-bulk")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "setup_parts",
                          "checks"]
    assert set(line["setup_parts"]) == {"start_s", "service_s", "warm_s"}  # no kernel off the card
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"serve_img_s", "setup_s"}
    assert all(k.startswith("check") for k in err[-len(line["checks"]):])
