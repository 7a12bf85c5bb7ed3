"""Peaks of the card, and the operations and bytes of kernel B1 (the
Muskingum-Cunge secant, ``mc_secant``) that its roofline share is taken
against.

Bytes: each of B1's 13 input arrays read once and each output array it
writes written once, over the lanes of the call.  On the timed path the
engine asks for no Courant diagnostics, so B1 writes 3 outputs (flow,
velocity, depth); it writes all 6 only when they are asked for.

Operations: the residual evaluations that the benchmark's frozen plain
secant (``reference/mc.py``) makes on the call's inputs, times the
operations of one evaluation, plus, once per lane with flow, the
operations of the lane's constants and of its final discharge and
velocity.  Both counts come from running that solver's one-lane form
(``solve_lane``'s ``evaluate``, ``lane_constants`` and ``finish``) on
numbers that count what is done to them: every addition, subtraction,
multiplication, division, square root and power counts one operation;
comparisons, selections, min, max, absolute values and negations count
none.  A division, a square root or a power costs the card several
instructions, so the count is a floor of the work, and the share errs
low.  The evaluation is counted on a lane within its banks, the
cheapest path through the celerity (an overbank evaluation also
computes the floodplain celerity); ``overbank_ops`` gives the other.
"""

from __future__ import annotations

from hydrobench.reference import mc

# published peaks (NVIDIA's data sheet, SXM part, dense, at the full
# power limit), keyed by torch.cuda.get_device_name()
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(f32_ops_per_s=67e12,
                                  bytes_per_s=3.35e12),
}
B1_INPUTS = 13
B1_OUTPUTS_TIMED = 3
BYTES_PER_VALUE = 4  # float32


class _Counter:
    ops = 0


class Counted:
    """A float that counts the arithmetic done on it in ``_Counter``."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v.v if isinstance(v, Counted) else float(v)

    @staticmethod
    def _val(o):
        return o.v if isinstance(o, Counted) else o

    def _op(self, v):
        _Counter.ops += 1
        return Counted(v)

    def __add__(self, o): return self._op(self.v + self._val(o))
    def __radd__(self, o): return self._op(self._val(o) + self.v)
    def __sub__(self, o): return self._op(self.v - self._val(o))
    def __rsub__(self, o): return self._op(self._val(o) - self.v)
    def __mul__(self, o): return self._op(self.v * self._val(o))
    def __rmul__(self, o): return self._op(self._val(o) * self.v)
    def __truediv__(self, o): return self._op(self.v / self._val(o))
    def __rtruediv__(self, o): return self._op(self._val(o) / self.v)
    def __pow__(self, o): return self._op(self.v ** self._val(o))
    def __neg__(self): return Counted(-self.v)
    def __abs__(self): return Counted(abs(self.v))
    def __lt__(self, o): return self.v < self._val(o)
    def __le__(self, o): return self.v <= self._val(o)
    def __gt__(self, o): return self.v > self._val(o)
    def __ge__(self, o): return self.v >= self._val(o)
    def __eq__(self, o): return self.v == self._val(o)
    def __ne__(self, o): return self.v != self._val(o)
    __hash__ = None

    def sqrt(self):
        return self._op(self.v ** 0.5)


# one lane of the CONUS ranges, in its banks (depth under bankfull)
_LANE = dict(qup=2.0, quc=2.1, qdp=1.9, ql=0.5, dx=1500.0, bw=10.0, tw=40.0,
             twcc=150.0, n=0.055, ncc=0.11, cs=0.8, s0=0.005, dt=300.0)


def _count(fn) -> int:
    _Counter.ops = 0
    fn()
    return _Counter.ops


def _evaluation_ops(depth: float) -> int:
    lane = {k: Counted(v) for k, v in _LANE.items()}
    L = mc.lane_constants(lane["bw"], lane["tw"], lane["twcc"], lane["n"],
                          lane["ncc"], lane["cs"], lane["s0"], lane["dt"])
    s = dict(h=Counted(depth * 1.33 + mc.MINDEPTH), h_0=Counted(depth * 0.67),
             qj0=Counted(0.0), c=(Counted(0.0),) * 4, x=Counted(0.0),
             rerror=1.0, aerror=mc.MINDEPTH, it=0)
    args = tuple(lane[k] for k in ("qup", "quc", "qdp", "ql", "dx", "bw",
                                   "twcc", "n", "ncc", "s0", "dt"))
    return _count(lambda: mc.evaluate(s, *args, L, 1e-38))


def evaluation_ops() -> int:
    """Operations of one in-bank residual evaluation."""
    return _evaluation_ops(0.5)


def overbank_ops() -> int:
    """Operations of one evaluation with both depths above bankfull."""
    return _evaluation_ops(30.0)


def lane_ops() -> int:
    """Operations a lane with flow does once: its constants, the first
    depths, the final discharge and velocity."""
    lane = {k: Counted(v) for k, v in _LANE.items()}

    def once():
        L = mc.lane_constants(lane["bw"], lane["tw"], lane["twcc"],
                              lane["n"], lane["ncc"], lane["cs"], lane["s0"],
                              lane["dt"])
        d0 = Counted(0.5)
        s = dict(h=d0 * 1.33 + mc.MINDEPTH, h_0=d0 * 0.67,
                 c=tuple(Counted(v) for v in (0.3, 0.2, 0.4, 0.1)))
        mc.finish(s, lane["qup"], lane["quc"], lane["qdp"], lane["bw"],
                  lane["n"], L)
    return _count(once)


def b1_bytes(lanes: int, outputs: int = B1_OUTPUTS_TIMED) -> int:
    return lanes * (B1_INPUTS + outputs) * BYTES_PER_VALUE


def b1_ops(evals: int, lanes_with_flow: int) -> int:
    return evals * evaluation_ops() + lanes_with_flow * lane_ops()


def least_time_s(ops: float, nbytes: float, peak: dict) -> tuple:
    """(least seconds, "ops" or "bytes"): the larger of the two bounds."""
    t_ops = ops / peak["f32_ops_per_s"]
    t_bytes = nbytes / peak["bytes_per_s"]
    return (t_ops, "ops") if t_ops > t_bytes else (t_bytes, "bytes")
