"""The program's own spans and counters, as per-layer readers take them.

The program (``troute_torch/tracing.py``) records spans and counters in
memory while a ``torch.profiler`` session runs, which is while the
harness traces its two stretches; the untraced window records nothing.
A reader calls ``program()`` after the window and gets every record of
both stretches: (name, start_ns, end_ns, parent, request), with
``parent`` the index of the enclosing record and ``request`` an id shared
by the records of one top-level call.  A checkout whose program records
nothing gives None, and the reader then reports nothing.
"""

from __future__ import annotations

import statistics
import sys


def program():
    """(records, counts) the program holds, or None where it has no
    tracing module or recorded no span."""
    try:
        from troute_torch import tracing
    except ImportError:
        return None
    recs = tracing.records()
    if not recs:
        return None
    return recs, tracing.counts()


def closed(recs, name: str) -> list:
    """The finished records named ``name``."""
    return [r for r in recs if r[0] == name and r[2] is not None]


def median_ms(recs, name: str):
    """Median duration of the records named ``name``, in ms; None where
    there is none."""
    ms = [(r[2] - r[1]) / 1e6 for r in closed(recs, name)]
    return statistics.median(ms) if ms else None


def median_per_request_ms(recs, names) -> float | None:
    """Median over requests of the summed durations of the records named
    in ``names``, in ms; None where there is none."""
    by = {}
    for r in recs:
        if r[0] in names and r[2] is not None:
            by[r[4]] = by.get(r[4], 0) + (r[2] - r[1])
    return statistics.median(by.values()) / 1e6 if by else None


def self_ns(recs) -> list:
    """Each record's duration less the durations of its child records
    (spans of one thread nest, so a record's children do not overlap);
    None for a record still open."""
    child = [0] * len(recs)
    for r in recs:
        if r[3] is not None and r[2] is not None and r[3] < len(recs):
            child[r[3]] += r[2] - r[1]
    return [None if r[2] is None else r[2] - r[1] - c
            for r, c in zip(recs, child)]


def breakdown_ms(recs, root: str) -> dict:
    """{name: median self time in ms} of the records named ``root`` (under
    the key ``root + ".self"``) and of each kind of record directly under
    one: what a layer's time is made of."""
    own = self_ns(recs)
    idx = {i for i, r in enumerate(recs) if r[0] == root}
    by = {}
    for i, r in enumerate(recs):
        if own[i] is None:
            continue
        if i in idx:
            by.setdefault(root + ".self", []).append(own[i])
        elif r[3] in idx:
            by.setdefault(r[0], []).append(own[i])
    return {k: statistics.median(v) / 1e6 for k, v in by.items()}


def step_host_ms():
    """The median duration of the program's ``engine.step`` spans, in ms
    (None where there is none); the median self times of the step and of
    each span under it go to standard error."""
    got = program()
    if got is None:
        return None
    recs = got[0]
    v = median_ms(recs, "engine.step")
    if v is not None:
        print(f"engine.step_host_ms: {v!r} ms over "
              f"{len(closed(recs, 'engine.step'))} steps; median self times "
              f"{breakdown_ms(recs, 'engine.step')} ms", file=sys.stderr)
    return v
