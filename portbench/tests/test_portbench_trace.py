"""The reduction of a traced window: the device's busy union and idle
gaps, the labels of the gaps, and the per-layer readers, on synthetic
events."""

from types import SimpleNamespace

import pytest

from portbench import core, trace
from portbench.trace import DeviceEvent, Trace

WINDOW = (1000.0, 2000.0)


def synthetic() -> Trace:
    dev = [DeviceEvent("kernel_a", "kernel", 1000.0, 1100.0),
           DeviceEvent("kernel_b", "kernel", 1050.0, 1200.0),      # overlaps a
           DeviceEvent("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1300.0, 1400.0),
           DeviceEvent("void bn_act_vec<bf16>", "kernel", 1405.0, 1500.0),
           DeviceEvent("kernel_a", "kernel", 1900.0, 1950.0)]
    spans = [("portbench.window", 1000.0, 2000.0), ("portbench.request", 1000.0, 1600.0),
             ("portbench.drain", 1250.0, 1450.0)]
    return Trace(WINDOW, dev, spans)


def test_union_busy_and_gaps():
    tr = synthetic()
    assert tr.union() == [(1000.0, 1200.0), (1300.0, 1400.0), (1405.0, 1500.0), (1900.0, 1950.0)]
    assert tr.busy_s() == pytest.approx(445e-6)
    assert tr.gaps() == [(1200.0, 100.0), (1400.0, 5.0), (1500.0, 400.0), (1950.0, 50.0)]
    assert tr.window_s == pytest.approx(1e-3)


def test_gaps_are_labelled_by_the_innermost_span():
    tr = synthetic()
    assert tr.span_at(1200.0) == "portbench.request"
    assert tr.span_at(1400.0) == "portbench.drain"
    assert tr.span_at(1700.0) == "portbench.window"
    b = tr.breakdown(top=2)
    assert b["idle_gaps"] == [["portbench.request", pytest.approx(400e-6)],
                              ["portbench.request", pytest.approx(100e-6)]]
    assert b["device_ops"][0] == ["kernel_a", pytest.approx(150e-6)]


def test_from_chrome_keeps_device_events_inside_the_window():
    events = [{"cat": "user_annotation", "name": "portbench.window", "ts": 100, "dur": 50},
              {"cat": "user_annotation", "name": "other", "ts": 100, "dur": 50},
              {"cat": "gpu_user_annotation", "name": "portbench.window", "ts": 100, "dur": 50},
              {"cat": "kernel", "name": "k", "ts": 90, "dur": 20},
              {"cat": "gpu_memset", "name": "Memset (Device)", "ts": 120, "dur": 5},
              {"cat": "kernel", "name": "late", "ts": 160, "dur": 5},
              {"cat": "cpu_op", "name": "aten::add", "ts": 110, "dur": 5}]
    tr = trace.from_chrome(events)
    assert tr.window == (100.0, 150.0)
    assert [(d.name, d.start, d.end) for d in tr.device] == [("k", 100.0, 110.0),
                                                            ("Memset (Device)", 120.0, 125.0)]
    assert tr.spans == [("portbench.window", 100.0, 150.0)]
    with pytest.raises(ValueError):
        trace.from_chrome(events[1:])


def rec(**counts):
    return SimpleNamespace(trace=synthetic(), counts=counts,
                           facts={"flops_per_step": 1e9, "flops_per_image": 2e6,
                                  "bn_act_bytes_per_render": 1e6, "bn_act_layers": 1})


def test_the_readers():
    r = rec(steps=2, rendered_images=10)
    assert core.reader("train.idle_pct")(r) == pytest.approx(55.5)
    assert core.reader("serve.idle_pct")(r) == pytest.approx(55.5)
    assert core.reader("train.gap_ms_per_step")(r) == pytest.approx((0.1 + 0.4 + 0.05) / 2)
    assert core.reader("serve.copy_pct")(r) == pytest.approx(100 * 100 / 445)
    assert core.reader("train.mfu_pct")(r) == pytest.approx(100 * 2e9 / (1e-3 * 989e12))
    assert core.reader("serve.mfu_pct")(r) == pytest.approx(100 * 2e7 / (1e-3 * 989e12))
    # one bn_act launch of 1e6 bytes in 95 µs against 3.35 TB/s
    assert core.reader("bn_act_roofline")(r) == pytest.approx(100 * (1e6 / 3.35e12) / 95e-6)


def test_a_reader_that_finds_nothing_returns_none():
    empty = SimpleNamespace(trace=Trace(WINDOW, [], []), counts={"steps": 0}, facts={})
    for name in ("train.idle_pct", "train.gap_ms_per_step", "train.mfu_pct", "serve.copy_pct",
                 "serve.mfu_pct", "bn_act_roofline", "serve.idle_pct"):
        assert core.reader(name)(empty) is None, name
