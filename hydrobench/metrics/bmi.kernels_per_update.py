"""bmi.kernels_per_update: device operations (kernels, memcpys and
memsets) in the traced stretch per coupling cycle traced."""

SOURCE = "device_trace"
MOVES = "updates_per_s"


def read(view):
    n = len(view.trace.kernels())
    return n / view.units if n and view.units else None
