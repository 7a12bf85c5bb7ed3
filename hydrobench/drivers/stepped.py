"""Driver of a configuration routed by ``route_stepped`` hour after hour,
as a forecast cycle works through its backlog: one caller hands each
hour's state to the next and waits for every hour (a closed loop).

Set-up builds the network from the seed (``gen/networks.py``), hands it
to the program as its command line would (``build_topology`` in post
order with the lakes as reservoir nodes, ``network_arrays_from_topology``,
channel and level-pool parameters in the program's row order), makes the
hourly forcing on the device (``gen/forcing.py``) and routes the traffic's
spin-up hours from a cold start, which also warms every shape the window
uses.  A unit of
the window is one hour: one ``route_stepped`` call of the configuration's
steps with ``collect=True``, and the harness's clock ends it with a
``torch.cuda.synchronize()``.

The program's row order is its own; the benchmark places its inputs in it
and reads its outputs back by the ids the program gives its rows.
"""

from __future__ import annotations

import importlib
import random
import sys

import numpy as np
import torch

from hydrobench.gen import forcing, networks
from hydrobench.roofline import b1_bytes, b1_ops


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

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from troute_torch.network.topology import (NODE_RESERVOIR,
                                                   build_topology)
        from troute_torch.ops.levelpool import LevelpoolParams
        from troute_torch.routing import engine

        dev, dt = self.device, self.dtype
        net = networks.conus_network(self.cfg["network"], self.seed)
        self.net = net
        n = net["ids"].size
        node_type = np.zeros(n, np.int8)
        node_type[net["lakes"]] = NODE_RESERVOIR
        topo = build_topology(net["ids"], net["down"], node_type,
                              row_order="postorder")
        self.program_net = engine.network_arrays_from_topology(topo,
                                                               device=dev)
        canon = np.asarray(topo.ids, np.int64) - 1
        self.canon_of_row = torch.as_tensor(canon, device=dev)
        self.row_of_canon = torch.as_tensor(np.argsort(canon), device=dev)
        self.res_rows = torch.as_tensor(np.asarray(topo.reservoir_rows,
                                                   np.int64), device=dev)
        lake_canon = canon[np.asarray(topo.reservoir_rows)]
        slot = np.searchsorted(net["lakes"], lake_canon)
        # the reference's lake j is the program's reservoir slot
        # lake_slot[j]
        self.lake_slot = torch.as_tensor(np.argsort(slot), device=dev)
        table = net["lake_params"][slot]
        self.chan = engine.ChannelParams.from_arrays(
            device=dev, dtype=dt,
            **{k: net["chan"][k][canon] for k in networks.CHANNEL_KEYS})
        self.lp = LevelpoolParams.from_array(table, device=dev, dtype=dt)
        r = self.cfg["routing"]
        self.rcfg = engine.RoutingConfig(
            dt=self.dt, nts=self.steps,
            qts_subdivisions=int(r["qts_subdivisions"]),
            assume_short_ts=bool(r["assume_short_ts"]))
        self.collect = bool(r["collect"])

        # a cold start, as T-Route starts without a restart file: channel
        # flows and depths 0, lakes at the level pool's start
        elev0 = torch.as_tensor(networks.initial_elevation(table),
                                dtype=dt, device=dev)
        q = torch.zeros(n, dtype=dt, device=dev)
        d = torch.zeros(n, dtype=dt, device=dev)
        d[self.res_rows] = elev0
        base = forcing.baseflow_ring(self.traffic, n, self.seed, dev, dt)
        spin = base[:, self.canon_of_row]
        ring = forcing.window_ring(self.traffic, base, self.seed)
        del base
        self.ring = ring[:, self.canon_of_row]
        del ring
        self.state = (q, d, elev0)
        for j in range(int(self.traffic["spinup_units"])):
            out = self._route(spin[j % spin.shape[0]][None])
            if j == 0:
                self.samples["start"] = (self.state, spin[0].clone(), out)
            self.state = self._next(out)
        del spin
        self.window_start = self.state

    def _route(self, qlat):
        from troute_torch.routing import engine
        q, d, elev = self.state
        return engine.route_stepped(self.program_net, self.chan, self.lp,
                                    self.rcfg, q, d, elev, qlat,
                                    collect=self.collect)

    @staticmethod
    def _next(out):
        st = out["state"]
        return (st.q, st.depth, st.res_elev)

    # ------------------------------------------------------------ window
    def unit_work(self) -> int:
        """Segment-timesteps of one unit: real segments x steps."""
        return int(self.net["ids"].size) * self.steps

    def unit(self, k: int) -> None:
        idx = k % self.ring.shape[0]
        state_in = self.state
        out = self._route(self.ring[idx:idx + 1])
        self.state = self._next(out)
        self._last = (state_in, idx, out)

    def after(self, k: int, ms: float) -> None:
        """Keep the hours the judge reads: a uniform sample of the window's
        hours drawn from the seed, and the slowest hour."""
        self.seen += 1
        state_in, idx, out = self._last
        item = (state_in, self.ring[idx], out)
        for j in range(int(self.cfg["judge"]["random_units"])):
            if self.seen == 1 or self.pick.random() < 1.0 / self.seen:
                self.samples[f"random{j}"] = item
        if ms > self.slowest:
            self.slowest = ms
            self.samples["slowest"] = item
        self._last = None

    def free_program(self) -> None:
        """Drop the program's network and state; the kept hours, and the
        forcing and start state the trace's counts read, stay."""
        self.state = self._last = None
        self.program_net = self.chan = self.lp = None

    # ------------------------------------------------------------ judge
    def _reference(self, dtype):
        net = self.net
        return self.reference.Network(net["ids"], net["down"], net["chan"],
                                    net["lakes"], net["lake_params"],
                                    device=self.device, dtype=dtype)

    def _canon(self, rows: torch.Tensor) -> torch.Tensor:
        return rows[self.row_of_canon]

    def _start(self, state):
        q, d, elev = state
        return self._canon(q), self._canon(d), elev[self.lake_slot]

    def _inputs(self, name: str):
        """The inputs of each step of kept hour ``name``, side by side, in
        the reference's order: the hour's start state for its first step,
        the program's own state after step t - 1 for step t."""
        state_in, ql_rows, out = self.samples[name]
        q0, d0, e0 = self._start(state_in)
        fvd = out["flowveldepth"]
        q = torch.stack([q0] + [self._canon(fvd[t][:, 0])
                                for t in range(self.steps - 1)])
        d = torch.stack([d0] + [self._canon(fvd[t][:, 2])
                                for t in range(self.steps - 1)])
        e = torch.stack([e0] + [fvd[t][self.res_rows, 2][self.lake_slot]
                                for t in range(self.steps - 1)])
        ql = self._canon(ql_rows).expand(self.steps, -1)
        return q, d, e, ql

    def judge(self, control: bool = False) -> dict:
        """The compared numbers of each kept hour, two ways.

        Step by step: the program's (or, for the control, the reference's
        in bfloat16) values of every step against one float32 reference
        step from the program's own state before it, and how far the state
        the program hands on lies from its last step's values.  The secant
        stops on a 1% step in depth, so a last-bit difference in a lane's
        inflow (the program adds upstream flows in another order) can move
        that lane's depth by tens of percent, and over later steps its
        flow; from the program's own state each step is judged alone.  The
        hour's first step starts from the state of the hour before (the
        cell's initial state for the first spin-up hour).  A lane whose
        values the reference's solve gives with its upstream sum moved in
        its last bits is judged no further (``Network.explained``).

        Free: the reference runs the whole hour from the hour's start state
        on its own, and each step's flows, summed over each basin, are held
        against the program's (``basin_q_rel``): a sum that a lane's depth
        moved by its secant cannot shift, and that drift over the hour
        would."""
        ref = self._reference(self.dtype)
        low = self._reference(torch.bfloat16) if control else None
        checks = {}
        for name in sorted(self.samples):
            inputs = self._inputs(name)
            want = ref.step(*inputs, self.dt)
            if control:
                got = [x.float() for x in low.step(*inputs, self.dt)[:3]]
            else:
                fvd = self.samples[name][2]["flowveldepth"]
                got = [torch.stack([self._canon(fvd[t][:, f])
                                    for t in range(self.steps)])
                       for f in range(3)]
            # lanes whose answer an upstream sum added in another order
            # gives are judged no further
            keep = ~ref.explained(*inputs[:2], inputs[3], got, want[:3],
                                  self.dt)
            tally = self.reference.Tally()
            tally.flows(got[0][keep], want[0][keep])
            tally.others(got[1][keep], want[1][keep])
            tally.others(got[2][keep], want[2][keep])
            checks[name] = tally.numbers()
            print(f"kept unit {name}: {int((~keep).sum())} lane-steps "
                  f"explained by their upstream sum's last bits",
                  file=sys.stderr)
            del want, keep
            start = [x[0] for x in inputs[:3]] + [inputs[3][0]]
            free = self._free_sums(ref, start)
            got_sums = (self._free_sums(low, start) if control
                        else ref.basin_sums(got[0]))
            checks[name]["basin_q_rel"] = self.reference.basin_gap(
                got_sums, free)
            del got, free, got_sums
            if not control:
                out = self.samples[name][2]
                st, last = out["state"], out["flowveldepth"][-1]
                checks[name]["state_gap"] = max(
                    float((st.q - last[:, 0]).abs().max()),
                    float((st.depth - last[:, 2]).abs().max()),
                    float((st.res_elev - last[self.res_rows, 2]).abs().max()))
        return checks

    def _free_sums(self, ref, start) -> torch.Tensor:
        """[steps, basins] basin sums of the flows of ``ref`` run free for
        one hour from ``start`` (q, d, lake elevations, lateral inflow)."""
        sums = []
        ref.run(*start, self.steps, self.dt,
                on_step=lambda t, q, v, d, e: sums.append(ref.basin_sums(q)))
        return torch.stack(sums)

    # ------------------------------------------------------------ trace
    def traced_steps(self, units: int) -> int:
        return units * self.steps

    def b1_calls(self, units: int) -> list:
        """Per step of the traced hours (the first ``units`` of the
        window): (operations, bytes) of B1 as the frozen reference counts
        them, on inputs it rebuilds from the window's start state."""
        ref = self._reference(self.dtype)
        q, d, elev = self._start(self.window_start)
        calls = []
        lanes = int(ref.chan_rows.numel())

        def count(t, q_, v_, d_, evals):
            calls.append((b1_ops(int(evals.sum()),
                                 int((evals > 0).sum())),
                          b1_bytes(lanes)))
        for k in range(units):
            ql = self._canon(self.ring[k % self.ring.shape[0]])
            q, _, d, elev = ref.run(q, d, elev, ql, self.steps, self.dt,
                                    on_step=count)
        return calls
