"""bmi.exchange_share: the share of the window's coupling-cycle wall time
spent in ``set_value`` and ``get_value``, in percent, from the benchmark's
own host-clock spans around those calls (summed over every cycle of the
window, the traced ones included)."""

SOURCE = "host_clock"
MOVES = "updates_per_s"


def read(view):
    d = view.driver
    return 100.0 * d.exchange_s / d.cycle_s if d.cycle_s > 0.0 else None
