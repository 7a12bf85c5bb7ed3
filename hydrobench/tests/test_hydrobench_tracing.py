"""The readers of the program's spans and counters (``spans.py`` and the
six metrics that use it) on hand-made records: the right median, sum or
count per request, and nothing read where the program recorded
nothing."""

import pytest

from hydrobench import harness, spans

R = tuple       # (name, start_ns, end_ns, parent, request)
MS = 1_000_000


def _hour(t0, request, first, step_ms, res_ms, up_ms):
    """One ``engine.route`` record and its steps, each with an upstream
    sum and a reservoir span, starting at index ``first``."""
    recs = [R(("engine.route", t0, t0 + 100 * MS, None, request))]
    t = t0
    for s, u, r in zip(step_ms, up_ms, res_ms):
        i = first + len(recs)
        recs.append(R(("engine.step", t, t + s * MS, first, request)))
        recs.append(R(("engine.upstream_sum", t, t + u * MS, i, request)))
        recs.append(R(("engine.reservoirs", t + u * MS, t + (u + r) * MS, i,
                       request)))
        t += s * MS
    return recs


CONUS = (_hour(0, 0, 0, [4, 6, 5], [2, 1, 3], [0.5, 0.25, 0.5])
         + _hour(10**9, 1, 10, [9, 7], [2, 2], [1.0, 1.0]))


def _bmi(request, t0, ingest, publish, first):
    return [R(("bmi.update_until", t0, t0 + 200 * MS, None, request)),
            R(("bmi.ingest", t0, t0 + ingest * MS, first, request)),
            R(("engine.route", t0 + 50 * MS, t0 + 60 * MS, first, request)),
            R(("bmi.publish", t0 + 100 * MS, t0 + (100 + publish) * MS,
               first, request))]


BMI = _bmi(0, 0, 30, 10, 0) + _bmi(1, 10**9, 50, 20, 4) \
    + _bmi(2, 2 * 10**9, 5, 1, 8)


@pytest.fixture
def program(monkeypatch):
    """Hand the readers ``recs`` and ``counts`` in place of the
    program's."""
    def use(recs, counts=None):
        got = None if recs is None else (recs, counts or {})
        monkeypatch.setattr(spans, "program", lambda: got)
    return use


@pytest.mark.parametrize("name, recs, counts, want", [
    # steps of 4, 6, 5, 9, 7 ms
    ("engine.step_host_ms.conus", CONUS, {}, 6.0),
    ("engine.step_host_ms.bmi", CONUS, {}, 6.0),
    ("upstream_sum.host_ms.conus", CONUS, {}, 0.5),
    ("reservoirs.host_ms.conus", CONUS, {}, 2.0),
    # 3 allocations over 2 hours
    ("engine.device_allocs_per_hour.conus", CONUS,
     {"cuda.device_allocs": 3}, 1.5),
    ("engine.device_allocs_per_hour.conus", CONUS,
     {"cuda.device_allocs": 0}, 0.0),
    # ingest + publish of each update: 40, 70, 6 ms
    ("bmi.marshal_ms", BMI, {}, 40.0),
])
def test_each_reader_on_hand_made_records(program, name, recs, counts,
                                          want):
    program(recs, counts)
    assert harness.load_metric(name).read(None) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "engine.step_host_ms.conus", "engine.step_host_ms.bmi",
    "upstream_sum.host_ms.conus", "reservoirs.host_ms.conus",
    "engine.device_allocs_per_hour.conus", "bmi.marshal_ms"])
@pytest.mark.parametrize("recs, counts", [
    (None, None),                  # a program that records nothing
    ([R(("other", 0, 5, None, 0))], {}),   # nothing of this reader's
])
def test_each_reader_reads_nothing_without_its_records(program, name, recs,
                                                       counts):
    program(recs, counts)
    assert harness.load_metric(name).read(None) is None


def test_the_counter_needs_its_hours_and_the_hours_their_counter(program):
    reader = harness.load_metric("engine.device_allocs_per_hour.conus")
    program(CONUS, {})
    assert reader.read(None) is None
    program([r for r in CONUS if r[0] != "engine.route"],
            {"cuda.device_allocs": 4})
    assert reader.read(None) is None


def test_a_program_without_tracing_reads_as_none(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "troute_torch" and "tracing" in (fromlist or ()):
            raise ImportError("no tracing module")
        return real(name, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", no_tracing)
    assert spans.program() is None


def test_self_times_and_the_breakdown():
    recs = [R(("engine.step", 0, 10 * MS, None, 0)),
            R(("engine.mc", MS, 4 * MS, 0, 0)),
            R(("engine.collect", 5 * MS, 6 * MS, 0, 0)),
            R(("engine.step", 20 * MS, 26 * MS, None, 1)),
            R(("engine.mc", 20 * MS, 23 * MS, 3, 1)),
            R(("engine.collect", 24 * MS, 26 * MS, 3, 1)),
            R(("open", 30 * MS, None, None, 2))]
    assert spans.self_ns(recs) == [6 * MS, 3 * MS, MS, MS, 3 * MS, 2 * MS,
                                   None]
    assert spans.breakdown_ms(recs, "engine.step") == {
        "engine.step.self": 3.5, "engine.mc": 3.0, "engine.collect": 1.5}
    assert spans.median_per_request_ms(recs, ("engine.mc",
                                              "engine.collect")) == 4.5
    assert spans.median_ms(recs, "open") is None
