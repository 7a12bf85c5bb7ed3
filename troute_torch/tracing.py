"""Spans and counters at the layer boundaries of the routing engine and
the BMI, recorded while a ``torch.profiler`` session runs.

Tracing is on exactly when a profiler is active (PyTorch's own flag,
``torch.autograd.profiler._is_profiler_enabled``, which the profiler sets
on start and clears on stop); nothing else turns it on or off.  Run the
command line or a BMI coupling under ``torch.profiler.profile`` and each
span appears on the profiler's timeline as a ``user_annotation`` event
beside the operators and kernels it launched, so a gap in the device
trace can be named by the layer whose host work filled it.

With no profiler running, ``span`` hands back one shared no-op context
(a module-attribute check, no allocation) and ``count`` does nothing.
While one runs, each span also keeps a record in memory, on the host's
``time.perf_counter_ns`` clock:

    (name, start_ns, end_ns, parent, request)

``parent`` is the index in ``records()`` of the enclosing span (None for
a top-level one), and ``request`` an id shared by every span of one
top-level call (one BMI ``update_until``, or one ``route``/
``route_stepped`` called outside the BMI).  Nothing is written to disk:
read the records with ``records()`` and ``counts()`` when the profiled
run ends, or take them with ``drain()``, between top-level calls.

Spans: ``bmi.update_until`` (with ``bmi.ingest`` before the engine and
``bmi.publish`` after it), ``engine.route`` (staging the DA inputs and the
driver), ``engine.step`` (one short step, with ``engine.upstream_sum``,
``engine.mc``, ``engine.reservoirs`` and ``engine.collect`` inside it),
and ``engine.collect`` again around the final stacks of the result.  With
data assimilation: ``engine.reservoir_da`` (the typed reservoir DA,
inside ``engine.reservoirs``), ``engine.nudge`` (gage nudging) and
``engine.da_handoff`` (the DA inputs of the next window), each entered
only when its DA data is given; ``engine.reservoir_da`` wraps the lakes'
whole level pool and DA, on a card one launch of the level-pool kernel's
DA form.
Counters: ``cuda.device_allocs``, the caching allocator's device
allocations (``cudaMalloc``) made inside ``engine.route`` on a CUDA
device; ``engine.nudge_lanes`` and ``engine.reservoir_da_lanes``, the
gage lanes nudged and the reservoir lanes the typed DA computes, added
each step (from shapes: no device read); ``engine.levelpool_launches``,
the launches of the level-pool kernel (``ops/levelpool_cuda.py``), one a
step with lakes on a card and none on the CPU; and
``engine.reservoir_da_launches``, those of its DA form alone, one a step
with lakes and DA on a card and none on the CPU.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _prof


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int | None      # None while the span is open
    parent: int | None      # index of the enclosing span in records()
    request: int


_records: list = []
_counts: dict = {}
_open: list = []            # indices of the spans open, innermost last
_requests = 0


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "index", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _requests
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        if _open:
            parent = _open[-1]
            request = _records[parent].request
        else:
            parent, request = None, _requests
            _requests += 1
        self.index = len(_records)
        _records.append(Record(self.name, time.perf_counter_ns(), None,
                               parent, request))
        _open.append(self.index)
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if _open and _open[-1] == self.index:
            _open.pop()
        i = self.index
        # a drain() inside the span took its record away
        if i < len(_records) and _records[i].name == self.name \
                and _records[i].end_ns is None:
            _records[i] = _records[i]._replace(end_ns=end)
        self.annotation.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's work: a no-op with no profiler
    running; else a ``record_function`` annotation and an in-memory
    record."""
    if not _prof._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _prof._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def device_allocs(device) -> int | None:
    """The caching allocator's count of device allocations on ``device``
    (``num_device_alloc``), read while tracing is on and ``device`` is a
    CUDA device; else None.  A read of host-side counters: no device
    operation and no synchronization."""
    if not _prof._is_profiler_enabled or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.memory_stats(device).get("num_device_alloc", 0))


def records() -> list:
    """The spans recorded so far, in the order they were entered."""
    return list(_records)


def counts() -> dict:
    """The counters recorded so far."""
    return dict(_counts)


def drain() -> tuple:
    """(records, counts) recorded so far, and forget them."""
    out = (list(_records), dict(_counts))
    _records.clear()
    _counts.clear()
    _open.clear()
    return out


def self_ns(recs) -> list:
    """Each record's duration less the time its child spans cover (the
    children of one span run one after another, so their durations add);
    None for a record still open."""
    child_ns = [0] * len(recs)
    for name, start, end, parent, _ in recs:
        if parent is not None and end is not None and parent < len(recs):
            child_ns[parent] += end - start
    return [None if r[2] is None else r[2] - r[1] - c
            for r, c in zip(recs, child_ns)]
