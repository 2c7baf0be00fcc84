"""The trace's reduction and the per-layer readers on events written by
hand: the busy union and the idle gaps, each kernel's launching operator,
the tail's kernels found after each ELL launch, and readers that find
nothing returning nothing."""

import pytest

from portbench import manifest, tracing
from portbench.tracing import Kernel, TraceView


def events():
    cpu = lambda name, ts, dur: {"cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "tid": 1}
    launch = lambda ts, corr: {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                               "dur": 1, "tid": 1, "args": {"correlation": corr}}
    kernel = lambda name, ts, dur, corr: {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
                                          "args": {"correlation": corr}}
    return [
        {"cat": "user_annotation", "name": tracing.CAPTURE, "ts": 0, "dur": 100, "tid": 1},
        cpu("aten::index_add_", 11, 9), cpu("aten::scatter", 12, 2),
        launch(11.5, 1), launch(13, 2), launch(30, 3),
        kernel("k_outer", 20, 10, 1), kernel("k_inner", 25, 15, 2), kernel("ell", 60, 10, 3),
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90, "dur": 20},
        cpu("aten::copy_", 75, 10),
    ]


def test_reduce_events():
    view = tracing.reduce_events(events(), 2)
    assert view.window_s == pytest.approx(100e-6)
    # busy: [20, 40] + [60, 70] + [90, 100] (the copy clipped to the capture)
    assert view.busy_s == pytest.approx(40e-6)
    assert [(k.name, k.op) for k in view.kernels] == [
        ("k_outer", "aten::index_add_"), ("k_inner", "aten::scatter"), ("ell", "")]
    # gaps: [0, 20] and [40, 60] at python, [70, 90] at aten::copy_ (its middle, 80)
    assert view.host_gaps == {"python": pytest.approx(40e-6), "aten::copy_": pytest.approx(20e-6)}
    assert view.top_device_ops(1) == [["k_inner", pytest.approx(15e-6)]]


def tail_view(ops):
    kernels = [Kernel("ell_spmm_kernel<true>", 0, 5, "")]
    kernels += [Kernel(f"k{i}", 10 + i, 2, op) for i, op in enumerate(ops)]
    return TraceView(1, 1.0, 0.5, [], kernels)


def test_the_tail_is_the_kernels_after_each_ell_launch():
    reader = manifest.reader("coo_tail_ms.train")
    ops = ["aten::gather", "aten::mul", "aten::index_add_"] * 2
    assert reader.read(tail_view(ops), {"pack": {"tail_chunks": 2}}) == pytest.approx(12e-6 * 1e3)
    assert reader.read(tail_view(ops[:-1] + ["aten::addmm"]), {"pack": {"tail_chunks": 2}}) is None
    assert reader.read(tail_view(ops), {"pack": {}}) is None


@pytest.mark.parametrize("name", [m["name"] for m in manifest.load()["per_layer"]])
def test_a_reader_that_finds_nothing_returns_nothing(name):
    assert manifest.reader(name).read(TraceView(0, 0.0, 0.0, [], []), {}) is None
