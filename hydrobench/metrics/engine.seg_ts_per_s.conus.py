"""engine.seg_ts_per_s.conus: real segments x routing steps completed per
second of host clock over the window's untraced part (every hour routed
after the traced stretches, from their end to the window's close), in
seg-ts/s.  The hour's rate is set by the host's launches, whose speed
drifts from run to run by more than an end-to-end bound can hold; here it
stands beside ``hour_p95_ms`` with no bound."""

SOURCE = "host_clock"
MOVES = "hour_p95_ms"


def read(view):
    if not view.free_units or view.free_s <= 0.0:
        return None
    return view.free_units * view.driver.unit_work() / view.free_s
