"""mc_secant_roofline: kernel B1's share of its roofline over the traced
steps, in percent: the least time the card could take for the calls (per
call the larger of operations over the f32 peak and bytes over the memory
peak, as ``hydrobench/roofline.py`` counts them from the frozen reference
on inputs it rebuilds) over B1's device time in the trace."""

import sys

from hydrobench.measure import smi_query
from hydrobench.roofline import least_time_s

SOURCE = "device_trace"
MOVES = "hour_p95_ms"
# B1's kernel name holds PATTERN; B2's (the block-skip form) holds SKIP
PATTERN = "mc_secant"
SKIP = "mc_secant_skip"


def read(view):
    if view.peak is None:
        return None
    kernels = [k for k in view.trace.kernels(PATTERN) if SKIP not in k[0]]
    if not kernels:
        return None
    calls = view.b1_calls()
    if len(calls) != len(kernels):
        print(f"mc_secant_roofline: {len(kernels)} B1 kernels traced for "
              f"{len(calls)} steps; not read", file=sys.stderr)
        return None
    least = [least_time_s(ops, nbytes, view.peak) for ops, nbytes in calls]
    bound = {}
    for t, which in least:
        bound[which] = bound.get(which, 0) + 1
    device_s = sum(b - a for _, a, b in kernels) / 1e6
    share = 100.0 * sum(t for t, _ in least) / device_s
    print(f"mc_secant_roofline: {share!r} % over {len(calls)} calls, "
          f"B1 {device_s!r} s on the device; bound by {bound}; "
          f"[{smi_query('name,power.limit')}]", file=sys.stderr)
    return share
