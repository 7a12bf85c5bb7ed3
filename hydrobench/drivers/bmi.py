"""Driver of a configuration coupled through the routing BMI, as NextGen
couples T-Route: one caller, one update per simulated hour, waiting for
each (a closed loop).

Set-up pushes the network from the seed through ``set_value`` (segments
in an order drawn from the seed, then the lakes: ``gen/networks.py``),
makes the traffic's ring of hourly inflow fields on the host (NumPy, as a
coupler hands them over) and runs the spin-up cycles, the first of which
builds the program's network.  A unit of the window is one coupling
cycle: ``set_value`` of the hour's inflow, ``update_until`` one hour
later, then ``get_value`` of the three channel outputs and the two lake
outputs.

The routing state the BMI carries from one update to the next is what its
outputs say (a segment's flow and depth; a lake's outflow and water
elevation), so the judge starts the reference of a kept cycle from the
outputs of the cycle before it.
"""

from __future__ import annotations

import importlib
import random
import time

import numpy as np
import torch

from hydrobench.gen import forcing, networks

INFLOW = "land_surface_water_source__volume_flow_rate"
OUTPUTS = ("channel_exit_water_x-section__volume_flow_rate",
           "channel_water_flow__speed", "channel_water__mean_depth",
           "lake_water~outgoing__volume_flow_rate", "lake_surface__elevation")


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        r = cfg["routing"]
        self.dt, self.steps = float(r["dt"]), int(r["steps_per_unit"])
        self.pick = random.Random(self.seed)
        # the configuration's plain reference (``reference/<name>.py``)
        self.reference = importlib.import_module(
            f"hydrobench.reference.{cfg['reference']}")
        self.samples: dict = {}
        self.slowest = -1.0
        self.seen = 0
        self.exchange_s = 0.0
        self.cycle_s = 0.0

    def setup(self) -> None:
        from troute_torch.bmi import BmiTroute

        v = networks.bmi_pushes(self.cfg["network"], self.seed)
        self.pushes = v
        n = v["segment_id"].size
        self.bmi = BmiTroute(device=self.device)
        self.bmi.initialize("")
        for name, val in v.items():
            self.bmi.set_value(name, val)
        self.ring = forcing.baseflow_ring(self.traffic, n, self.seed, "cpu",
                                          torch.float64).numpy()
        self.time = 0.0
        # the state before the first cycle, as outputs would say it
        self.prev = (np.zeros(n), np.zeros(n), np.zeros(n), v["qd0"].copy(),
                     v["h0"].copy())
        for j in range(int(self.traffic["spinup_units"])):
            prev = self.prev
            self._cycle(j % self.ring.shape[0])
            if j == 0:
                self.samples["start"] = (prev, j % self.ring.shape[0],
                                         self.prev)

    def _cycle(self, idx: int) -> tuple:
        """One coupling cycle; returns the seconds spent in set_value and
        get_value, and in the whole cycle, by the host's clock."""
        bmi = self.bmi
        t0 = time.perf_counter()
        bmi.set_value(INFLOW, self.ring[idx])
        t1 = time.perf_counter()
        self.time += self.steps * self.dt
        bmi.update_until(self.time)
        t2 = time.perf_counter()
        self.prev = tuple(bmi.get_value(name) for name in OUTPUTS)
        t3 = time.perf_counter()
        return (t1 - t0) + (t3 - t2), t3 - t0

    def unit_work(self) -> int:
        return 1

    def unit(self, k: int) -> None:
        idx = k % self.ring.shape[0]
        prev = self.prev
        exchange, cycle = self._cycle(idx)
        self.exchange_s += exchange
        self.cycle_s += cycle
        self._last = (prev, idx, self.prev)

    def after(self, k: int, ms: float) -> None:
        """Keep the cycles the judge reads: a uniform sample of the window's
        cycles drawn from the seed, and the slowest cycle."""
        self.seen += 1
        for j in range(int(self.cfg["judge"]["random_units"])):
            if self.seen == 1 or self.pick.random() < 1.0 / self.seen:
                self.samples[f"random{j}"] = self._last
        if ms > self.slowest:
            self.slowest = ms
            self.samples["slowest"] = self._last
        self._last = None

    def free_program(self) -> None:
        self.bmi.finalize()
        self.bmi = None

    # ------------------------------------------------------------ judge
    def _reference(self, dtype):
        v = self.pushes
        ids = np.concatenate([v["segment_id"], v["waterbody_id"]])
        down = np.concatenate([v["segment_toid"], v["waterbody_toid"]])
        n = v["segment_id"].size
        chan = {k: np.concatenate([np.asarray(v[k], np.float32),
                                   np.ones(v["waterbody_id"].size,
                                           np.float32)])
                for k in networks.CHANNEL_KEYS}
        table = np.stack([v[c] for c in networks.LAKE_COLUMNS], 1)
        return self.reference.Network(
            ids, down, chan, np.arange(n, ids.size), table,
            device=self.device, dtype=dtype)

    def _run(self, ref, prevs, idxs):
        """The reference's five outputs after one cycle from each of the
        outputs ``prevs`` of the cycle before, with the inflow fields
        ``idxs``, routed side by side."""
        n = self.pushes["segment_id"].size

        def t(rows):
            return torch.as_tensor(np.stack(rows), device=self.device
                                   ).to(self.dtype)
        q = torch.cat([t([p[0] for p in prevs]), t([p[3] for p in prevs])], 1)
        d = torch.cat([t([p[2] for p in prevs]), t([p[4] for p in prevs])], 1)
        elev = t([p[4] for p in prevs])
        ql = torch.cat([t([self.ring[i] for i in idxs]),
                        torch.zeros_like(elev)], 1)
        q, v, d, elev = ref.run(q, d, elev, ql, self.steps, self.dt)
        return [(q[b, :n], v[b, :n], d[b, :n], q[b, n:], elev[b])
                for b in range(len(prevs))]

    def judge(self, control: bool = False) -> dict:
        """The compared numbers of each kept cycle: the five outputs the
        program gave (or, for the control, the reference's in bfloat16)
        against the float32 reference run from the outputs of the cycle
        before, which are the whole state the BMI carries: flows value by
        value, depths, velocities and lake elevations by the share off
        (the reference's ``Tally``)."""
        v = self.pushes
        sizes = [v["segment_id"].size] * 3 + [v["waterbody_id"].size] * 2
        out, ok = {}, []
        for name, (prev, idx, got) in sorted(self.samples.items()):
            if [np.asarray(a).size for a in prev + got] == sizes * 2:
                ok.append(name)
            else:
                # outputs of the wrong length are wrong answers
                out[name] = dict(q_max_rel=float("inf"),
                                 off_share=float("inf"))
        if not ok:
            return out
        prevs = [self.samples[k][0] for k in ok]
        idxs = [self.samples[k][1] for k in ok]
        want = self._run(self._reference(self.dtype), prevs, idxs)
        got = (self._run(self._reference(torch.bfloat16), prevs, idxs)
               if control else
               [[torch.as_tensor(np.asarray(a)) for a in self.samples[k][2]]
                for k in ok])
        for name, g, w in zip(ok, got, want):
            tally = self.reference.Tally()
            g = [x.cpu() for x in g]
            w = [x.cpu() for x in w]
            tally.flows(torch.cat([g[0], g[3]]), torch.cat([w[0], w[3]]))
            for i in (1, 2, 4):
                tally.others(g[i], w[i])
            out[name] = tally.numbers()
        return out

    def traced_steps(self, units: int) -> int:
        return units * self.steps
