"""The fine-tune's BN statistics reader, ``finetune.moments_roofline``, on
a synthetic traced window, beside the readers ``test_the_readers``
(test_portbench_trace.py) checks: the share it reads, and None where no
moments kernel ran (the forward on the plain sums)."""

from types import SimpleNamespace

import pytest

from portbench import core
from portbench.layer_metrics._device import PEAK_HBM_BYTES
from portbench.trace import DeviceEvent, Trace

FACTS = {"bn_act_bytes_per_step": 4.0e9, "bn_act_layers": 94}
NS = "void (anonymous namespace)::"


def _window(*named):
    """A 1 ms window holding kernels (name, start µs, length µs)."""
    return Trace((0.0, 1000.0), [DeviceEvent(n, "kernel", t, t + d) for n, t, d in named],
                 [("portbench.window", 0.0, 1000.0)])


def test_the_moments_reader():
    tr = _window((NS + "bn_moments_partial<__nv_bfloat16, 8>", 0.0, 20.0),
                 (NS + "bn_moments_combine(float const*, float*, long, long)", 20.0, 3.0),
                 ("void bn_act_vec<__nv_bfloat16, 1>", 23.0, 50.0),
                 (NS + "bn_moments_partial<__nv_bfloat16, 8>", 73.0, 24.0),
                 (NS + "bn_moments_combine(float const*, float*, long, long)", 97.0, 3.0),
                 ("reduce_kernel<512, 1>", 100.0, 40.0))
    read = core.reader("finetune.moments_roofline")
    # two layers: 2 × 0.5 × 4e9 / 94 bytes at 3.35 TB/s against their four kernels' 50 µs
    want = 100.0 * 2 * 0.5 * 4.0e9 / 94 / PEAK_HBM_BYTES / 50e-6
    assert read(SimpleNamespace(trace=tr, facts=FACTS, counts={})) == pytest.approx(want)


def test_the_moments_reader_finds_nothing_without_its_kernels():
    read = core.reader("finetune.moments_roofline")
    plain = _window(("void bn_act_vec<__nv_bfloat16, 1>", 0.0, 50.0),
                    ("reduce_kernel<512, 1>", 50.0, 100.0))
    moments = _window((NS + "bn_moments_partial<__nv_bfloat16, 8>", 0.0, 9.0))
    for nothing in (SimpleNamespace(trace=plain, facts=FACTS, counts={}),
                    SimpleNamespace(trace=None, facts=FACTS, counts={}),
                    SimpleNamespace(trace=Trace((0.0, 1.0)), facts=FACTS, counts={}),
                    SimpleNamespace(trace=moments, facts={}, counts={})):
        assert read(nothing) is None
