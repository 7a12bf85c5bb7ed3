"""engine.kernels_per_step.ana: device operations (kernels, memcpys and
memsets) in the traced stretch per routing step traced, in the analysis
cycle: an exact count of what the driver loop with DA launches, the
hand-off included."""

SOURCE = "device_trace"
MOVES = "hour_p95_ms"


def read(view):
    n = len(view.trace.kernels())
    return n / view.steps if n and view.steps else None
