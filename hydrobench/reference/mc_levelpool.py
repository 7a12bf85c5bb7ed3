"""Plain reference of short-timestep Muskingum-Cunge routing with
level-pool lakes: the reference of both configurations
(``nwm_conus_short``, ``nextgen_vpu_bmi``).

The semantics are T-Route's short-timestep mode (``mc_reach.pyx``,
``assume_short_ts``): at each step every segment sees the sum of its
upstream flows at the previous step as both its previous and its current
upstream inflow, solves the MC secant (``reference/mc.py``), and every lake
receives that same sum as inflow to one level-pool step
(``reference/levelpool.py``); a lake's flow column holds its outflow and
its depth column its water elevation, its velocity is 0.

Everything is worked out here from node ids and downstream ids: the
upstream lists, the row of each lake, the sums (columns added left to
right in ascending node order).  Nothing of the program is imported or
read but the values it is judged on.
"""

from __future__ import annotations

import numpy as np
import torch

from hydrobench.reference import levelpool, mc

CHANNEL_KEYS = ("dx", "bw", "tw", "twcc", "n", "ncc", "cs", "s0")
# relative errors are taken against max(|reference|, FLOOR)
FLOOR = 1e-3
# a value is "off" past this relative error
OFF_REL = 1e-4
# ``explained``: the units in the last place by which a lane's upstream
# inflow is moved each way, the most lanes it looks at, and how close the
# moved solve has to come to the program's values
ULPS = 4
EXPLAIN_CAP = 20_000
MATCH_REL = 1e-6


def upstream_lists(ids: np.ndarray, down: np.ndarray) -> np.ndarray:
    """[N, K] rows of each node's upstream nodes, ascending, -1 padded; a
    downstream id that is no node's (0 among them) ends the network."""
    ids = np.asarray(ids, np.int64)
    down = np.asarray(down, np.int64)
    order = np.argsort(ids)
    at = np.clip(np.searchsorted(ids[order], down), 0, ids.size - 1)
    found = ids[order][at] == down
    src = np.flatnonzero(found)
    dst = order[at][found]
    sort = np.lexsort((src, dst))
    src, dst = src[sort], dst[sort]
    indeg = np.bincount(dst, minlength=ids.size)
    out = np.full((ids.size, max(int(indeg.max(initial=0)), 1)), -1,
                  np.int64)
    first = np.concatenate([[0], np.cumsum(indeg)])
    out[dst, np.arange(src.size) - first[dst]] = src
    return out


def outlets(ids: np.ndarray, down: np.ndarray) -> np.ndarray:
    """[N] the row of the outlet each node drains to (its own row for an
    outlet), by pointer jumping down the network."""
    ids = np.asarray(ids, np.int64)
    down = np.asarray(down, np.int64)
    order = np.argsort(ids)
    at = np.clip(np.searchsorted(ids[order], down), 0, ids.size - 1)
    nxt = np.where(ids[order][at] == down, order[at], np.arange(ids.size))
    while True:
        jump = nxt[nxt]
        if np.array_equal(jump, nxt):
            return nxt
        nxt = jump


class Network:
    """A network in the reference's own row order (the order its ids are
    given in), on one device in one dtype.

    ``chan``: {key: [N]} channel parameters (lake rows ignored);
    ``lakes``: rows of the lakes, ascending; ``lake_params``: their
    [n_lakes, >= 8] level-pool parameters in that order."""

    def __init__(self, ids, down, chan: dict, lakes, lake_params, *,
                 device, dtype=torch.float32):
        self.n = int(np.asarray(ids).size)
        self.device, self.dtype = torch.device(device), dtype
        up = upstream_lists(ids, down)
        self.up = torch.as_tensor(up, device=device)
        self.lakes = torch.as_tensor(np.asarray(lakes, np.int64),
                                     device=device)
        is_lake = np.zeros(self.n, bool)
        is_lake[np.asarray(lakes, np.int64)] = True
        self.chan_rows = torch.as_tensor(np.flatnonzero(~is_lake),
                                         device=device)
        self.chan = {k: torch.as_tensor(np.asarray(chan[k]), device=device
                                        ).to(dtype)[self.chan_rows]
                     for k in CHANNEL_KEYS}
        self.lake_params = torch.as_tensor(
            np.asarray(lake_params, np.float64)[:, :8], device=device
        ).to(dtype)
        _, basin = np.unique(outlets(ids, down), return_inverse=True)
        self.basin = torch.as_tensor(basin.reshape(-1), device=device)
        self.n_basins = int(basin.max(initial=-1)) + 1

    def basin_sums(self, q: torch.Tensor) -> torch.Tensor:
        """[..., n_basins] float64 sums of [..., N] values over each basin
        (the nodes that drain to one outlet)."""
        q = q.to(torch.float64)
        out = torch.zeros((*q.shape[:-1], self.n_basins),
                          dtype=torch.float64, device=q.device)
        return out.index_add_(-1, self.basin, q)

    def explained(self, q, d, ql, got, want, dt: float) -> torch.Tensor:
        """bool [..., N]: the channel lanes where the program's step (``got``:
        flows, velocities, depths) is off the reference's (``want``) by
        more than ``OFF_REL`` and yet is the reference's own solve from the
        same state with the lane's upstream inflow moved by at most
        ``ULPS`` units in its last place.  Adding a lane's upstream flows
        in another order moves their sum by such units, and the secant can
        turn that into a different depth; an answer altered, a lane left
        out or one solved in a lower precision is explained by nothing.
        Past ``EXPLAIN_CAP`` lanes nothing is explained."""
        rel = torch.stack([(g.double() - w.double()).abs()
                           / w.double().abs().clamp_min(FLOOR)
                           for g, w in zip(got, want)]).nan_to_num(
                               nan=float("inf")).amax(0)
        cand = rel > OFF_REL
        cand[..., self.lakes] = False
        out = torch.zeros_like(cand)
        idx = torch.nonzero(cand.reshape(-1, self.n))
        if idx.shape[0] == 0 or idx.shape[0] > EXPLAIN_CAP:
            return out
        b, i = idx[:, 0], idx[:, 1]
        lane = torch.full((self.n,), -1, dtype=torch.int64,
                          device=self.device)
        lane[self.chan_rows] = torch.arange(self.chan_rows.numel(),
                                            device=self.device)
        flat = [x.reshape(-1, self.n) for x in (q, d, ql)]
        up = self.upstream_sum(flat[0])[b, i]
        ups, lo, hi = [up], up, up
        for _ in range(ULPS):
            lo = torch.nextafter(lo, torch.full_like(lo, -float("inf")))
            hi = torch.nextafter(hi, torch.full_like(hi, float("inf")))
            ups += [lo, hi]
        k = len(ups)
        up = torch.cat(ups)

        def rep(x):
            return x.repeat(k)
        c = {key: rep(v[lane[i]]) for key, v in self.chan.items()}
        qdc, velc, depthc, _ = mc.solve(
            up, up, rep(flat[0][b, i]), rep(flat[2][b, i]), c["dx"],
            c["bw"], c["tw"], c["twcc"], c["n"], c["ncc"], c["cs"], c["s0"],
            rep(flat[1][b, i]), dt)
        match = torch.ones(k * b.numel(), dtype=torch.bool,
                           device=self.device)
        for mine, theirs in zip((qdc, velc, depthc), got):
            g = rep(theirs.reshape(-1, self.n)[b, i]).double()
            match &= (mine.double() - g).abs() \
                <= MATCH_REL * g.abs().clamp_min(FLOOR)
        out.reshape(-1, self.n)[b, i] = match.view(k, -1).any(0)
        return out

    def upstream_sum(self, q: torch.Tensor) -> torch.Tensor:
        vals = torch.where(self.up >= 0, q[..., self.up.clamp_min(0)], 0.0)
        acc = torch.zeros_like(q)
        for k in range(vals.shape[-1]):
            acc = acc + vals[..., k]
        return acc

    def step(self, q, d, elev, ql, dt: float):
        """One short step of [..., N] states (a leading dimension routes
        independent states side by side): (q, v, d, elev, evals per channel
        lane)."""
        up = self.upstream_sum(q)
        rows = self.chan_rows
        lead = q.shape[:-1]

        def lanes(x):
            return x[..., rows].reshape(-1)
        c = {k: v.expand(*lead, -1).reshape(-1) for k, v in self.chan.items()}
        qdc, velc, depthc, evals = mc.solve(
            lanes(up), lanes(up), lanes(q), lanes(ql), c["dx"], c["bw"],
            c["tw"], c["twcc"], c["n"], c["ncc"], c["cs"], c["s0"], lanes(d),
            dt)
        q_new, v_new, d_new = q.clone(), torch.zeros_like(q), d.clone()
        shape = (*lead, rows.numel())
        q_new[..., rows] = qdc.view(shape)
        v_new[..., rows] = velc.view(shape)
        d_new[..., rows] = depthc.view(shape)
        if self.lakes.numel():
            inflow = up[..., self.lakes]
            out, elev = levelpool.step(elev, inflow, inflow,
                                       torch.zeros_like(inflow), dt,
                                       self.lake_params)
            q_new[..., self.lakes] = out
            d_new[..., self.lakes] = elev
        return q_new, v_new, d_new, elev, evals.view(shape)

    def run(self, q, d, elev, ql, steps: int, dt: float, on_step=None):
        """``steps`` short steps from (q, d, elev) with lateral inflow
        ``ql``, each [..., N] (lakes [..., n_lakes]); ``on_step(t, q, v, d,
        evals)`` sees each step.  Returns the final (q, v, d, elev)."""
        q, d, elev, ql = (t.to(self.dtype) for t in (q, d, elev, ql))
        v = torch.zeros_like(q)
        for t in range(steps):
            q, v, d, elev, evals = self.step(q, d, elev, ql, dt)
            if on_step is not None:
                on_step(t, q, v, d, evals)
        return q, v, d, elev


def basin_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative gap between basin sums ``got`` and ``want``,
    against max(|want|, ``FLOOR``); inf where ``got`` is not finite."""
    rel = (got - want).abs() / want.abs().clamp_min(FLOOR)
    rel = torch.where(torch.isfinite(rel), rel,
                      torch.full_like(rel, float("inf")))
    return float(rel.max()) if rel.numel() else 0.0


class Tally:
    """Running comparison of program values against reference values:
    the largest relative error of the flows, and the share of all values
    (flows, depths, velocities, lake elevations) off by more than
    ``OFF_REL``.  The secant stops on a 1% step in depth, so a last-bit
    change in a lane's inflow can move its depth and velocity by tens of
    percent while its flow moves by less than 0.1%: flows are held value
    by value, the rest only by the share that is off."""

    def __init__(self):
        self.q_max_rel = 0.0
        self.off = 0
        self.total = 0

    def _count(self, got, want) -> torch.Tensor:
        got = got.to(torch.float64)
        want = want.to(torch.float64)
        rel = (got - want).abs() / want.abs().clamp_min(FLOOR)
        rel = torch.where(torch.isfinite(rel), rel,
                          torch.full_like(rel, float("inf")))
        self.off += int((rel > OFF_REL).sum())
        self.total += rel.numel()
        return rel

    def flows(self, got: torch.Tensor, want: torch.Tensor) -> None:
        """Flows, value by value (pass only the values to be judged)."""
        rel = self._count(got, want)
        if rel.numel():
            self.q_max_rel = max(self.q_max_rel, float(rel.max()))

    def others(self, got: torch.Tensor, want: torch.Tensor) -> None:
        self._count(got, want)

    def numbers(self) -> dict:
        return dict(q_max_rel=self.q_max_rel,
                    off_share=(self.off / self.total if self.total
                               else float("inf")))
