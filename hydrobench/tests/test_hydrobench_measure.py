"""Statistics over the whole window, the device trace's arithmetic and the
import check."""

import sys

import pytest

from hydrobench import measure


def test_p95_is_taken_over_every_sample_and_sees_a_stall():
    lat = [10.0] * 190 + [11.0] * 9 + [500.0]
    assert measure.p95(lat) == 10.0
    # eleven stalled hours among 200: the tail is the stall
    assert measure.p95([10.0] * 189 + [500.0] * 11) == 500.0
    assert measure.p95([3.0]) == 3.0
    assert measure.p95(list(range(1, 101))) == 95
    with pytest.raises(ValueError):
        measure.p95([])


def test_rate_takes_all_work_and_all_time_of_the_window():
    # 99 hours of 10 ms and one of 1 s: the rate sees the stall whole
    hours = [0.01] * 99 + [1.0]
    work = 100 * 12 * 2_729_077
    assert measure.rate(work, sum(hours)) == pytest.approx(
        work / 1.99)
    with pytest.raises(ValueError):
        measure.rate(1, 0.0)


def test_the_per_layer_rate_takes_the_untraced_window_whole():
    from types import SimpleNamespace

    from hydrobench import harness
    reader = harness.load_metric("engine.seg_ts_per_s.conus")
    driver = SimpleNamespace(unit_work=lambda: 12 * 2_729_077)
    view = SimpleNamespace(driver=driver, free_units=1000, free_s=44.5)
    assert reader.read(view) == pytest.approx(1000 * 12 * 2_729_077 / 44.5)
    # nothing routed after the traced stretches: nothing to read
    assert reader.read(SimpleNamespace(driver=driver, free_units=0,
                                       free_s=44.5)) is None


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert measure.busy_union(spans) == 12 + 10 + 1
    assert measure.merged(spans) == [[0, 12], [20, 30], [40, 41]]
    assert measure.gaps_in(spans, 0, 50) == [(12, 20), (30, 40), (41, 50)]
    assert measure.gaps_in(spans, 8, 22) == [(12, 20)]


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


def test_trace_idle_share_and_breakdown():
    events = [
        _ev("user_annotation", "stretch", 100, 100),
        _ev("cpu_op", "aten::cat", 100, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 125, 5),
        _ev("kernel", "void mc_secant_kernel<float>(...)", 120, 30),
        _ev("kernel", "elementwise", 140, 20),     # overlaps the first
        _ev("gpu_memcpy", "Memcpy DtoH", 170, 10),
        _ev("gpu_memset", "Memset", 190, 10),
        _ev("kernel", "outside the stretch", 300, 10),
        _ev("cpu_op", "aten::item", 178, 14),
    ]
    tr = measure.Trace(events, "stretch")
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((40 + 10 + 10) * 1e-6)
    assert measure.idle_share_pct(tr) == pytest.approx(40.0)
    assert len(tr.kernels()) == 4 and len(tr.kernels("mc_secant")) == 1
    assert tr.top_ops(2) == [["void mc_secant_kernel<float>(...)",
                              pytest.approx(30e-6)],
                             ["elementwise", pytest.approx(20e-6)]]
    idle = dict(tr.idle_by_host())
    # 100-120 under aten::cat, 160-170 under no host event, 180-190
    # under aten::item; the stretch itself names what nothing else does
    assert idle == {"aten::cat": pytest.approx(20e-6),
                    "python between operators": pytest.approx(10e-6),
                    "aten::item": pytest.approx(10e-6)}
    assert measure.idle_share_pct(measure.Trace([], "stretch")) is None


def test_a_trace_without_host_events_is_bounded_by_the_device():
    events = [_ev("kernel", "a", 1000, 30), _ev("kernel", "b", 1150, 50)]
    tr = measure.Trace(events)
    assert tr.window_s == pytest.approx(200e-6)
    assert tr.busy_s == pytest.approx(80e-6)
    assert measure.idle_share_pct(tr) == pytest.approx(60.0)


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    mods = {"troute_torch": 1, "troute_torch.routing": 1, "benchmarks": 1,
            "benchmark_x": 1, "jaxtyping": 1, "hydrobench.bench": 1,
            "jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "troute_tpu.ops": 1,
            "bench": 1, "flax.linen": 1}
    assert measure.foreign_modules(modules=mods) == [
        "bench", "flax.linen", "jax", "jax.numpy", "jaxlib.xla",
        "troute_tpu.ops"]
    assert measure.foreign_modules(("troute_torch",), mods) == [
        "troute_torch", "troute_torch.routing"]
    assert ("jax" in sys.modules) == ("jax" in measure.foreign_modules())
