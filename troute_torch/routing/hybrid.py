"""Hybrid MC + diffusive-wave routing.

Port of ``troute_tpu/routing/hybrid.py`` and of the JAX command line's
hybrid run (``troute_tpu/cli.py:814-979``).  The reference's
one-directional coupling (``compute.py:1740-1884``,
``AbstractRouting.py:209-327``): the diffusive mainstem domain is carved
out of the MC network; MC routes everything else first; MC flows at the
junctions draining into the mainstem become tributary boundary series
(``qtrib_g``) for the diffusive solver, which then routes the mainstem
with its own lateral inflows.

``HybridDomain`` is host NumPy, as in the JAX package, up to
``build_diffusive_domain``, which puts the solver's domain on an explicit
device in an explicit torch dtype.  ``run_mainstem`` is the hybrid run of
the command line (and of ``chip_smoke.py``): one batch lane per tailwater
tree, the saves brought to the host in one transfer, the mainstem columns
appended to the MC flows.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import yaml

from troute_torch.network import graph

LOG = logging.getLogger(__name__)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class HybridDomain:
    """Preprocessed diffusive mainstem + coupling metadata."""

    def __init__(self, cfg, base: Path):
        from troute_torch.io.routelink import read_routelink

        hp = cfg.compute_parameters.hybrid_parameters
        sp = cfg.network_topology_parameters.supernetwork_parameters
        with open(base / hp.diffusive_domain) as f:
            dd = yaml.safe_load(f)
        self._set_mainstem(dd)
        columns = sp.columns.model_dump() if sp.columns else None
        mask_ids = None
        if sp.mask_file_path:
            mask_ids = np.loadtxt(base / sp.mask_file_path, dtype=np.int64,
                                  ndmin=1)
        rl = read_routelink(base / sp.geo_file_path, columns, mask_ids)
        self._build(rl)

    @classmethod
    def from_routelink(cls, rl, diffusive_domain: dict) -> "HybridDomain":
        """The domain of an in-memory ``RouteLinkData`` and a
        diffusive-domain mapping ({tailwater: {"links": [...]}} or
        {tailwater: [...]}, as the YAML file holds it): no file is read."""
        self = cls.__new__(cls)
        self._set_mainstem(diffusive_domain)
        self._build(rl)
        return self

    def _set_mainstem(self, dd: dict) -> None:
        self.mainstem_ids: list[int] = []
        for tw, spec in dd.items():
            links = spec["links"] if isinstance(spec, dict) else spec
            self.mainstem_ids.extend(int(x) for x in links)
        self.mainstem_set = set(self.mainstem_ids)

    def _build(self, rl):
        pos = {int(s): k for k, s in enumerate(rl.ids)}
        ms = [s for s in self.mainstem_ids if s in pos]
        ms_set = set(ms)

        # mainstem sub-graph -> junction-break reaches in topological order.
        # Junctions are counted on the FULL network so a node receiving an
        # external (MC) tributary starts a new reach — matching the
        # reference, whose reach decomposition happens before the domain
        # split, making tributaries upstream *reaches* in frnw.
        conn_all = dict(zip(rl.ids.tolist(), rl.downstream.tolist()))
        full_indeg: dict[int, int] = {}
        for s, d in conn_all.items():
            full_indeg[d] = full_indeg.get(d, 0) + 1
        conn = {s: ([conn_all[s]] if conn_all[s] in ms_set else [])
                for s in ms}
        rconn = graph.reverse_network(conn)
        keep = lambda path, n: full_indeg.get(n, 0) == 1
        reaches = graph.dfs_reach_decomposition(rconn, keep_going=keep)
        self.reaches = reaches
        seg_reach = {}
        for ri, r in enumerate(reaches):
            for s in r:
                seg_reach[s] = ri
        R = len(reaches)

        # reach topology
        ds_reach = np.full(R, -1, np.int32)
        for ri, r in enumerate(reaches):
            d = conn[r[-1]]
            if d:
                ds_reach[ri] = seg_reach[d[0]]
        self.ds_reach = ds_reach

        # adjusted altitudes (reference adj_alt1): interior nodes use their
        # own alt; a reach's bottom node takes the downstream reach-head alt
        # (or slope-extrapolates at the tailwater)
        alt = rl.alt if rl.alt is not None else np.zeros(rl.ids.size,
                                                        np.float32)

        def seg(k, s):
            return float(rl.channel[k][pos[s]])

        self.reach_nodes = []
        for ri, r in enumerate(reaches):
            n_seg = len(r)
            ncomp = n_seg + 1
            z = np.zeros(ncomp)
            geo = {k: np.zeros(ncomp) for k in
                   ("dx", "bo", "traps", "tw", "twcc", "mann", "manncc")}
            for i, s in enumerate(r):
                z[i] = alt[pos[s]]
                geo["dx"][i] = seg("dx", s)
                geo["bo"][i] = seg("bw", s)
                cs = max(seg("cs", s), 1e-6)
                geo["traps"][i] = 1.0 / cs
                geo["tw"][i] = seg("tw", s)
                geo["twcc"][i] = seg("twcc", s)
                geo["mann"][i] = seg("n", s)
                geo["manncc"][i] = seg("ncc", s)
            # bottom (ghost/junction) node duplicates the last segment's
            # geometry (reference fp_chgeo_map: segID = seg_list[ncomp-2])
            for k in geo:
                geo[k][-1] = geo[k][-2]
            last = r[-1]
            d = conn[last]
            if d:
                z[-1] = alt[pos[d[0]]]
            else:
                z[-1] = z[-2] - seg("s0", last) * seg("dx", last)
            self.reach_nodes.append(dict(z=z, **geo))

        # tributary MC segments draining into each reach head
        trib_of_reach: dict[int, list[int]] = {ri: [] for ri in range(R)}
        ms_head = {r[0]: ri for ri, r in enumerate(reaches)}
        # also mid-reach entry can't happen (junction breaks), but tributary
        # junctions into non-head mainstem segments would violate that —
        # reaches were split at junctions of the FULL graph upstream count?
        # rconn above is mainstem-only; recompute entries from the full graph
        self.trib_segments = []
        trib_entry = []
        for k, s in enumerate(rl.ids):
            s = int(s)
            if s in ms_set:
                continue
            d = int(rl.downstream[k])
            if d in ms_set:
                self.trib_segments.append(s)
                trib_entry.append(d)
        self.trib_entry = trib_entry
        # entry node: (reach, node index within reach)
        self.trib_reach = np.array([seg_reach[d] for d in trib_entry],
                                   np.int32)
        self.trib_node = np.array(
            [reaches[seg_reach[d]].index(d) for d in trib_entry], np.int32)

        self.seg_reach = seg_reach
        self.n_reaches = R
        # per-mainstem-segment geometry kept for the refactored-network
        # length-weighted remaps (qlat, dx, output crosswalk)
        self.seg_geo = {int(s): {k: seg(k, s) for k in
                                 ("dx", "bw", "tw", "twcc", "n", "ncc",
                                  "cs", "s0")}
                        for s in ms}
        self.refac = False

    def load_topobathy(self, path):
        """Load natural cross-section bathymetry and map it to reach nodes
        (reference ``fp_naturalxsec_map``, diffusive_utils_v02.py:394-500:
        interior nodes use their own segment's section; a reach's bottom
        node uses the downstream reach head's; the tailwater ghost node
        reuses the last segment's section lowered by s0*dx).

        Accepts the NetCDF format (link/xid_d/z/n) or the HYFeatures
        parquet variant indexed by ``hy_id`` with 'wb-' prefixes
        (reference ``MCwithDiffusiveNatlXSectionNonRefactored.topobathy_df``,
        AbstractRouting.py:388-401)."""
        if str(path).endswith(".parquet"):
            import pandas as pd
            df = pd.read_parquet(path)
            if "hy_id" in df.columns:
                df = df.set_index("hy_id")
            idx = [int(str(i).split("-")[-1]) for i in df.index]
            links = np.asarray(idx, np.int64)
            xid_d = df["xid_d"].to_numpy(np.float64)
            zb = df["z"].to_numpy(np.float64)
            nb = df["n"].to_numpy(np.float64)
        else:
            from troute_torch.io.netcdf import NetCDFFile

            with NetCDFFile(path) as f:
                links = f.read("link").astype(np.int64)
                xid_d = np.asarray(f.read("xid_d"), np.float64)
                zb = np.asarray(f.read("z"), np.float64)
                nb = np.asarray(f.read("n"), np.float64)
        by_link: dict[int, list[int]] = {}
        for k, l in enumerate(links):
            by_link.setdefault(int(l), []).append(k)

        def section(seg):
            idxs = by_link.get(int(seg))
            if not idxs:
                return None
            idxs = np.asarray(idxs)
            return xid_d[idxs], zb[idxs], nb[idxs]

        self.natural_xsec = {}
        for ri, r in enumerate(self.reaches):
            n_seg = len(r)
            for i, s in enumerate(r):
                sec = section(s)
                if sec is not None:
                    self.natural_xsec[(ri, i)] = sec
            # bottom node
            d = self.ds_reach[ri]
            if d >= 0:
                sec = section(self.reaches[d][0])
            else:
                sec = section(r[-1])
                if sec is not None:
                    geo = self.reach_nodes[ri]
                    drop = (geo["z"][-2] - geo["z"][-1])
                    sec = (sec[0], sec[1] - drop, sec[2])
            if sec is not None:
                self.natural_xsec[(ri, n_seg)] = sec
        return len(self.natural_xsec)

    def load_refactored(self, domain_path, topobathy_path):
        """Switch the diffusive solver onto the refactored hydrofabric.

        The reference's refactored path (``run_refactored_network``) solves
        the diffusive wave on resampled ("refactored") links and crosswalks
        results back to the original segments by length fractions
        (legacy ``fp_refactored_network_map``/``fp_refactored_qlat_iniq_dx_map``,
        diffusive_utils.py:555-788, and the in-kernel remap
        diffusive.f90:851-930; the v02 assembly references those arrays but
        never builds them, so the semantics here follow the legacy module).

        The refactored-domain YAML gives, per unrefactored tailwater:
        ``rlinks`` (refactored mainstem links), ``incoming_tribs``
        (unrefactored tributary -> entry rlink), ``lengthMap``
        (rlink -> "seg.f" strings where the decimal fraction x 10 is the
        length share of unrefactored ``seg`` inside the rlink,
        diffusive_utils.py:762-771), and ``refac_tw``.
        """
        from troute_torch.io.netcdf import NetCDFFile

        with open(domain_path) as f:
            dd = yaml.safe_load(f)

        with NetCDFFile(topobathy_path) as f:
            links = f.read("link").astype(np.int64)
            to = f.read("to").astype(np.int64)
            xid_d = np.asarray(f.read("xid_d"), np.float64)
            zb = np.asarray(f.read("z"), np.float64)
            nb = np.asarray(f.read("n"), np.float64)
        by_link: dict[int, list[int]] = {}
        link_to: dict[int, int] = {}
        for k, l in enumerate(links):
            by_link.setdefault(int(l), []).append(k)
            link_to[int(l)] = int(to[k])

        rlinks: list[int] = []
        incoming: dict[int, int] = {}
        members: dict[int, list[tuple[int, float]]] = {}
        self.refac_tw_map: dict[int, int] = {}
        for u_tw, spec in dd.items():
            rlinks.extend(int(x) for x in spec["rlinks"])
            incoming.update({int(k): int(v)
                             for k, v in (spec.get("incoming_tribs")
                                          or {}).items()})
            self.refac_tw_map[int(u_tw)] = int(spec["refac_tw"])
            for rl, val in (spec.get("lengthMap") or {}).items():
                mem = []
                for tok in str(val).split(","):
                    x = float(tok)
                    seg_id = int(x)
                    frac = round((x - seg_id) * 10.0, 6)
                    mem.append((seg_id, frac))
                members[int(rl)] = mem
        rset = set(rlinks)

        # refactored mainstem graph; junction breaks where a tributary
        # enters (reach heads), mirroring the unrefactored decomposition
        conn = {rl: ([link_to[rl]] if link_to.get(rl) in rset else [])
                for rl in rlinks}
        rconn = graph.reverse_network(conn)
        trib_heads = set(incoming.values())
        keep = lambda path, n: (len(rconn.get(n, ())) <= 1
                                and n not in trib_heads)
        reaches = graph.dfs_reach_decomposition(rconn, keep_going=keep)
        R = len(reaches)
        seg_reach = {s: ri for ri, r in enumerate(reaches) for s in r}
        ds_reach = np.full(R, -1, np.int32)
        for ri, r in enumerate(reaches):
            d = conn[r[-1]]
            if d:
                ds_reach[ri] = seg_reach[d[0]]

        def rlink_dx(rl):
            """Length from the unrefactored members (legacy
            fp_refactored_qlat_iniq_dx_map: sum dx*frac*10 -> here frac is
            already the share)."""
            tot = 0.0
            for s, frac in members.get(rl, ()):
                g = self.seg_geo.get(s)
                if g:
                    tot += g["dx"] * frac
            return tot if tot > 0 else 100.0

        def wavg(rl, key):
            num = den = 0.0
            for s, frac in members.get(rl, ()):
                g = self.seg_geo.get(s)
                if g:
                    w = g["dx"] * frac
                    num += g[key] * w
                    den += w
            return num / den if den > 0 else None

        def zmin(rl):
            idxs = by_link.get(rl)
            return float(zb[np.asarray(idxs)].min()) if idxs else 0.0

        reach_nodes = []
        for ri, r in enumerate(reaches):
            ncomp = len(r) + 1
            z = np.zeros(ncomp)
            geo = {k: np.zeros(ncomp) for k in
                   ("dx", "bo", "traps", "tw", "twcc", "mann", "manncc")}
            defaults = dict(bo=5.0, tw=15.0, twcc=45.0, mann=0.05,
                            manncc=0.1)
            for i, rl in enumerate(r):
                z[i] = zmin(rl)
                geo["dx"][i] = rlink_dx(rl)
                geo["bo"][i] = wavg(rl, "bw") or defaults["bo"]
                cs = wavg(rl, "cs") or 1.0
                geo["traps"][i] = 1.0 / max(cs, 1e-6)
                geo["tw"][i] = wavg(rl, "tw") or defaults["tw"]
                geo["twcc"][i] = wavg(rl, "twcc") or defaults["twcc"]
                geo["mann"][i] = wavg(rl, "n") or defaults["mann"]
                geo["manncc"][i] = wavg(rl, "ncc") or defaults["manncc"]
            for k in geo:
                geo[k][-1] = geo[k][-2]
            d = conn[r[-1]]
            if d:
                z[-1] = zmin(d[0])
            else:
                s0 = wavg(r[-1], "s0") or 1e-3
                z[-1] = z[-2] - s0 * geo["dx"][-2]
            reach_nodes.append(dict(z=z, **geo))

        # natural cross sections from the refactored bathymetry
        natural = {}

        def section(rl):
            idxs = by_link.get(int(rl))
            if not idxs:
                return None
            idxs = np.asarray(idxs)
            return xid_d[idxs], zb[idxs], nb[idxs]

        for ri, r in enumerate(reaches):
            for i, rl in enumerate(r):
                sec = section(rl)
                if sec is not None:
                    natural[(ri, i)] = sec
            d = ds_reach[ri]
            if d >= 0:
                sec = section(reaches[d][0])
            else:
                sec = section(r[-1])
                if sec is not None:
                    drop = reach_nodes[ri]["z"][-2] - reach_nodes[ri]["z"][-1]
                    sec = (sec[0], sec[1] - drop, sec[2])
            if sec is not None:
                natural[(ri, len(r))] = sec

        # tributary entries: unrefactored MC tributaries mapped through
        # incoming_tribs; unmapped tributaries are dropped with a warning
        trib_segments, trib_reach, trib_node = [], [], []
        dropped = 0
        for s in self.trib_segments:
            rl = incoming.get(int(s))
            if rl is None or rl not in seg_reach:
                dropped += 1
                continue
            trib_segments.append(s)
            trib_reach.append(seg_reach[rl])
            trib_node.append(reaches[seg_reach[rl]].index(rl))
        if dropped:
            LOG.warning("refactored network: %d tributaries have no "
                        "incoming_tribs mapping and were dropped", dropped)

        # keep the unrefactored reach list for the output crosswalk
        self.unrefac_reaches = self.reaches
        self.reaches = reaches
        self.reach_nodes = reach_nodes
        self.ds_reach = ds_reach
        self.n_reaches = R
        self.seg_reach = seg_reach
        self.trib_segments = trib_segments
        self.trib_reach = np.asarray(trib_reach, np.int32)
        self.trib_node = np.asarray(trib_node, np.int32)
        self.natural_xsec = natural
        self.refac_members = members
        self.refac = True
        return R

    def load_coastal_boundary(self, nc_path, domain_path, t0) -> bool:
        """Stage the coastal observed-depth downstream boundary
        (dsbc_option == 1).  Maps crosswalked tailwater segment ids to
        tailwater reach rows; returns True when any tailwater is covered
        (reference AbstractNetwork.py:144-158 + fp_coastal_boundary_input_map,
        diffusive_utils_v02.py:576-656)."""
        from troute_torch.io.coastal import coastal_db_for_domain

        tw_reach = self.tailwater_reaches()
        db, dt_db = coastal_db_for_domain(
            nc_path, domain_path, t0, list(tw_reach), self.n_reaches,
            tw_reach)
        if db is None:
            return False
        self.coastal_db = db
        self.coastal_dt_db = dt_db
        return True

    def tailwater_reaches(self) -> dict:
        """{tailwater segment id: reach row} of the tailwater reaches.  A
        coastal crosswalk keys UNREFACTORED tailwater ids, so on a
        refactored network they map to the refactored tailwater rows."""
        tw_reach = {int(self.reaches[ri][-1]): ri
                    for ri in range(self.n_reaches)
                    if self.ds_reach[ri] < 0}
        if self.refac:
            tw_reach = {u_tw: tw_reach[r_tw]
                        for u_tw, r_tw in self.refac_tw_map.items()
                        if r_tw in tw_reach}
        return tw_reach

    def tailwater_groups(self):
        """Reach-index sets of the independent tailwater trees.

        The reference invokes the diffusive kernel once per tailwater
        domain (each yaml key), giving every tree its own adaptive
        ``calculateDT``; grouping reaches by their tailwater root lets
        the batched [B, R, C] runner reproduce that."""
        ds = np.asarray(self.ds_reach)
        memo: dict[int, int] = {}

        def rootof(j: int) -> int:
            path = []
            while ds[j] >= 0 and j not in memo:
                path.append(j)
                j = int(ds[j])
            r = memo.get(j, j)
            for p in path:
                memo[p] = r
            return r

        groups: dict[int, list[int]] = {}
        for j in range(len(ds)):
            groups.setdefault(rootof(j), []).append(j)
        return [np.asarray(groups[k], np.int64) for k in sorted(groups)]

    def build_diffusive_domain(self, qlat_rows, dt_qlat, trib_q, dt_trib,
                               dtini, *, device, dtype=torch.float64,
                               reach_idx=None, nel_uniform=None):
        """Assemble the solver domain on ``device`` in ``dtype``.

        Args:
            qlat_rows: {segment id: [n_tq] lateral inflow (m3/s)}
            dt_qlat: spacing of the qlat series (s)
            trib_q: [n_tt, n_trib] MC flows at tributary segments
            dt_trib: spacing of the tributary series (s)
            dtype: torch.float64 (reference precision, the default) or
                torch.float32
            reach_idx: optional reach indices (one ``tailwater_groups``
                entry) — builds the domain restricted to that tree, with
                reach rows in ``reach_idx`` order
        """
        from troute_torch.diffusive.domain import build_domain

        if reach_idx is None:
            idx = np.arange(self.n_reaches, dtype=np.int64)
        else:
            idx = np.asarray(reach_idx, np.int64)
        local = {int(g): k for k, g in enumerate(idx)}
        reaches = [self.reaches[g] for g in idx]
        reach_nodes = [self.reach_nodes[g] for g in idx]
        ds_full = np.asarray(self.ds_reach)
        ds_reach = np.array(
            [local[int(ds_full[g])] if ds_full[g] >= 0 else -1
             for g in idx], np.int32)

        R = len(reaches)
        C = max(len(r["z"]) for r in reach_nodes)
        n_ql = (len(next(iter(qlat_rows.values()))) if qlat_rows else 2)

        qlat = np.zeros((n_ql, R, C))
        for ri, r in enumerate(reaches):
            ncomp = len(r) + 1
            off = C - ncomp
            for i, s in enumerate(r):
                if self.refac:
                    # length-weighted aggregate of the unrefactored member
                    # inflow shares (legacy fp_refactored_qlat_iniq_dx_map,
                    # diffusive_utils.py:757-784)
                    series = None
                    for seg_id, frac in self.refac_members.get(int(s), ()):
                        q = qlat_rows.get(seg_id)
                        if q is not None:
                            part = np.asarray(q)[:n_ql] * frac
                            series = part if series is None \
                                else series + part
                else:
                    series = qlat_rows.get(int(s))
                if series is not None:
                    # convert segment inflow (m3/s) to per-meter rate
                    qlat[:, ri, off + i] = np.asarray(series)[:n_ql] \
                        / max(float(reach_nodes[ri]["dx"][i]), 1e-6)

        n_tt = trib_q.shape[0] if trib_q is not None else 2
        trib = np.zeros((n_tt, R))
        if trib_q is not None and len(self.trib_segments):
            # tributaries enter at reach heads (full-network junction breaks)
            for ti, ri in enumerate(self.trib_reach):
                if int(ri) in local:
                    trib[:, local[int(ri)]] += trib_q[:, ti]

        natural_xsec = getattr(self, "natural_xsec", None)
        if natural_xsec is not None and reach_idx is not None:
            natural_xsec = {(local[ri], ni): v
                            for (ri, ni), v in natural_xsec.items()
                            if ri in local}
        db_depth = getattr(self, "coastal_db", None)
        if db_depth is not None and reach_idx is not None:
            db_depth = np.asarray(db_depth)[idx]

        return build_domain(reach_nodes, ds_reach, qlat,
                            dt_qlat, trib, dt_trib, dtini, device=device,
                            dtype=dtype, natural_xsec=natural_xsec,
                            db_depth=db_depth,
                            dt_db=getattr(self, "coastal_dt_db", 3600.0),
                            nel_uniform=nel_uniform)

    @staticmethod
    def _saves_to_host(saves, shape):
        """Stack save snapshots into host [n_saves, *shape] arrays: tensors
        are stacked on their device and copied in one transfer.  An empty
        save list gives empty [0, *shape] arrays (the JAX package raises
        IndexError there, ``troute_tpu/routing/hybrid.py:545``)."""
        if not saves:
            empty = np.zeros((0,) + tuple(shape))
            return empty, empty.copy()
        q_list = [q for _, q, _ in saves]
        y_list = [y for _, _, y in saves]
        if isinstance(q_list[0], np.ndarray):
            return np.stack(q_list), np.stack(y_list)
        qy = _host(torch.stack([torch.stack(q_list), torch.stack(y_list)]))
        return qy[0], qy[1]

    def saves_to_segments(self, saves, dom):
        """Map solver snapshots to per-mainstem-segment series.

        Returns ({segment id: q [n_saves]}, {segment id: depth [n_saves]}).
        The reference maps node i of reach j back to ``seg_list[i]``
        (``diffusive_utils_v02.unpack_output``).
        """
        if self.refac:
            return self._refac_saves_to_segments(saves, dom)
        C = int(dom.n_cols)
        z = _host(dom.z)
        q_out = {}
        d_out = {}
        qs, ys = self._saves_to_host(saves, z.shape)      # [n_saves, R, C]
        for ri, r in enumerate(self.reaches):
            ncomp = len(r) + 1
            off = C - ncomp
            for i, s in enumerate(r):
                q_out[s] = qs[:, ri, off + i].astype(np.float64)
                d_out[s] = (ys[:, ri, off + i]
                            - z[ri, off + i]).astype(np.float64)
        return q_out, d_out

    def _refac_saves_to_segments(self, saves, dom):
        """Crosswalk refactored-node results back to unrefactored segments.

        Per refactored link (node interval i -> i+1), flow and depth vary
        linearly with distance; each unrefactored member link is assigned
        the value at its top-node distance (the in-kernel remap,
        diffusive.f90:870-915, evaluated at ``dst_top`` the first time a
        link is covered)."""
        C = int(dom.n_cols)
        z = _host(dom.z)
        dx = _host(dom.dx)
        qs, ys = self._saves_to_host(saves, z.shape)          # [n_s, R, C]
        q_out, d_out = {}, {}
        for ri, r in enumerate(self.reaches):
            ncomp = len(r) + 1
            off = C - ncomp
            for i, rl in enumerate(r):
                q1 = qs[:, ri, off + i]
                q2 = qs[:, ri, off + i + 1]
                d1 = ys[:, ri, off + i] - z[ri, off + i]
                d2 = ys[:, ri, off + i + 1] - z[ri, off + i + 1]
                rdx = max(float(dx[ri, off + i]), 1e-6)
                dst = 0.0
                for seg_id, frac in self.refac_members.get(int(rl), ()):
                    g = self.seg_geo.get(seg_id)
                    if g is None:
                        continue
                    if seg_id not in q_out:   # value at the top node
                        w = dst / rdx
                        q_out[seg_id] = q1 * (1 - w) + q2 * w
                        d_out[seg_id] = d1 * (1 - w) + d2 * w
                    dst += g["dx"] * frac
        return q_out, d_out


def mainstem_qlat(hyb: HybridDomain, qlat_source, n_rows: int):
    """Lateral inflow of the mainstem segments (sorted ids), as the JAX
    command line reads it (``troute_tpu/cli.py:838-859``): ``qlat_source``
    is a non-empty list of CHRTOUT files, the path of a CSV indexed by
    segment id (short files repeat their last row up to ``n_rows``), or a
    constant.  Returns (ids int64 [M], qlat [n, M])."""
    ms_ids = np.asarray(sorted(hyb.mainstem_set), np.int64)
    if isinstance(qlat_source, (list, tuple)):
        from troute_torch.io.forcing import read_qlat_chrtout
        ql_ms = read_qlat_chrtout(list(qlat_source), ms_ids)
    elif isinstance(qlat_source, (str, Path)):
        from troute_torch.io.forcing import read_qlat_csv
        ql_ms = read_qlat_csv(qlat_source, ms_ids)
        if ql_ms.shape[0] < n_rows:
            ql_ms = np.concatenate(
                [ql_ms, np.repeat(ql_ms[-1:], n_rows - ql_ms.shape[0], 0)])
        ql_ms = ql_ms[:n_rows]
    else:
        ql_ms = np.full((n_rows, ms_ids.size), float(qlat_source),
                        np.float32)
    return ms_ids, ql_ms


def run_mainstem(hyb: HybridDomain, fvd: np.ndarray, ids, q0, qlat_source,
                 dt: float, qts: int, hp, device, *, out_ids=None,
                 n_qlat_rows: int | None = None, stats: dict | None = None,
                 group=None) -> dict:
    """Route the diffusive mainstem after the MC run and merge it into the
    MC output (the JAX command line's hybrid branch,
    ``troute_tpu/cli.py:814-979``).

    Args:
        fvd: [T, N, 3] host MC flows, velocities and depths
        ids: [N] segment ids of the MC rows (tributaries are found there)
        q0: [N] MC flows at t0 (the tributary series' first row)
        qlat_source: ``mainstem_qlat``'s source; ``n_qlat_rows`` (default
            ceil(T / qts)) rows for a CSV or a constant
        hp: the config's ``hybrid_parameters`` (dtype and tables resolved
            for ``device``, ``diffusive_batching``, ``diffusive_corrector``)
        out_ids: [N] ids of the output rows (default ``ids``)
        stats: the solver's counters (``run_diffusive``)
        group: a process group whose ranks share the batch's lanes (the
            JAX command line's sharded branch, ``shard_batched_domains``);
            every rank returns the whole result.  None routes every lane
            here.

    Returns a dict: 'fvd' [T, N + M, 3] with the M mainstem segments
    appended (flow, 0, depth), 'ids' [N + M], 'diffusive' ({'ids', 'q',
    'depth'} per save), 'seconds' of host wall time, 'n_saves', and
    'dtype' and 'nel' as resolved.

    One branch of the JAX command line is left out: the float64 fallback
    to the host CPU (``F64_OFFCPU_MAX_R``), which works around a fault of
    the TPU toolchain (a GPU computes float64 natively).
    """
    from troute_torch.diffusive.domain import stack_domains
    from troute_torch.diffusive.solver import (
        gather_batched_saves, initialize_state, initialize_state_batched,
        run_diffusive, run_diffusive_batched, shard_batched_domains)
    from troute_torch.network.builder import positions_of

    t_start = time.time()
    device = torch.device(device)
    total_steps = fvd.shape[0]
    # tributary MC flows at the boundary segments (t0 state prepended)
    rows, found = positions_of(np.asarray(ids, np.int64),
                               np.asarray(hyb.trib_segments, np.int64))
    trib_q = np.zeros((total_steps + 1, rows.size))
    trib_q[0, found] = np.asarray(q0)[rows[found]]
    trib_q[1:, found] = fvd[:, rows[found], 0]
    if not found.all():
        LOG.warning("%d diffusive tributaries missing from the MC network "
                    "(masked/collapsed); using zero inflow",
                    int((~found).sum()))

    if n_qlat_rows is None:
        n_qlat_rows = max(1, -(-total_steps // qts))
    ms_ids, ql_ms = mainstem_qlat(hyb, qlat_source, n_qlat_rows)
    qlat_rows = {int(s): ql_ms[:, k] for k, s in enumerate(ms_ids)}

    dtype_str, nel = hp.resolved_diffusive(device.type)
    dtype = torch.float32 if dtype_str == "float32" else torch.float64
    mode = hp.diffusive_corrector
    groups = hyb.tailwater_groups()
    q0val = float(trib_q[0].sum()) / max(hyb.n_reaches, 1)
    kw = dict(dt_qlat=dt * qts, trib_q=trib_q, dt_trib=dt, dtini=dt,
              device=device, dtype=dtype, nel_uniform=nel)
    if str(getattr(hp, "diffusive_batching", "auto")) != "never" \
            and len(groups) > 1:
        # one batch lane per tailwater tree: each runs its own adaptive-dt
        # loop, like the reference's per-domain diffnw
        doms = [hyb.build_diffusive_domain(qlat_rows, reach_idx=g, **kw)
                for g in groups]
        bdom = stack_domains(doms)
        B, Rb, Cb = bdom.z.shape
        q_init = torch.clamp_min(torch.full((B, Rb, Cb), q0val, dtype=dtype,
                                            device=device), 0.1)
        dst = initialize_state_batched(bdom, q_init, dtini_min=dt / 10.0)
        run_dom = bdom
        if group is not None:
            # each rank routes a contiguous slice of the independent lanes
            run_dom, dst, _ = shard_batched_domains(bdom, dst, group)
        dst, bsaves = run_diffusive_batched(
            run_dom, dst, t_final=total_steps * dt, save_interval=dt,
            corrector_mode=mode, stats=stats)
        if group is not None:
            bsaves = gather_batched_saves(bsaves, B, group)
        # scatter the lanes back into the merged [R, C] layout (every tree
        # pads to the widest reach, so lane rows are right-aligned at the
        # merged width); one transfer for z and dx, one for the saves
        R, C = hyb.n_reaches, Cb
        zdx = _host(torch.stack([bdom.z, bdom.dx]))
        qn, yn = HybridDomain._saves_to_host(bsaves, (B, Rb, Cb))
        z_m, dx_m = np.zeros((R, C)), np.ones((R, C))
        q_m = np.zeros((qn.shape[0], R, C))
        y_m = np.zeros_like(q_m)
        for g, gi in enumerate(groups):
            z_m[gi] = zdx[0, g, :len(gi)]
            dx_m[gi] = zdx[1, g, :len(gi)]
            q_m[:, gi] = qn[:, g, :len(gi)]
            y_m[:, gi] = yn[:, g, :len(gi)]
        saves = [(t_s, q_m[k], y_m[k]) for k, (t_s, _, _) in enumerate(bsaves)]
        dom = SimpleNamespace(z=z_m, dx=dx_m, n_cols=C)
    else:
        dom = hyb.build_diffusive_domain(qlat_rows, **kw)
        q_init = torch.clamp_min(torch.full(
            (dom.n_reaches, dom.n_cols), q0val, dtype=dtype, device=device),
            0.1)
        dst = initialize_state(dom, q_init, dtini_min=dt / 10.0)
        dst, saves = run_diffusive(dom, dst, t_final=total_steps * dt,
                                   save_interval=dt, corrector_mode=mode,
                                   stats=stats)
    q_seg, d_seg = hyb.saves_to_segments(saves, dom)
    n_s = len(saves)
    diffusive = {"ids": np.asarray(list(q_seg), np.int64),
                 "q": np.stack(list(q_seg.values()), axis=1) if q_seg
                 else np.zeros((n_s, 0)),
                 "depth": np.stack(list(d_seg.values()), axis=1) if d_seg
                 else np.zeros((n_s, 0))}
    LOG.info("diffusive mainstem: %d reaches, %d saves", hyb.n_reaches, n_s)

    # merge the mainstem results into the output table (reference
    # nwm_output_generator concatenates diffusive results into
    # flowveldepth, output.py:208-217); missing save rows repeat the last
    # save, or are zero when there is none
    dq = diffusive["q"][:total_steps]
    dd = diffusive["depth"][:total_steps]
    if dq.shape[0] < total_steps:
        pad = total_steps - dq.shape[0]
        fill_q = (np.repeat(dq[-1:], pad, 0) if dq.shape[0]
                  else np.zeros((pad, dq.shape[1])))
        fill_d = (np.repeat(dd[-1:], pad, 0) if dd.shape[0]
                  else np.zeros((pad, dd.shape[1])))
        dq = np.concatenate([dq, fill_q])
        dd = np.concatenate([dd, fill_d])
    ms_fvd = np.stack([dq, np.zeros_like(dq), dd], axis=-1)
    base_ids = np.asarray(ids if out_ids is None else out_ids)
    return {"fvd": np.concatenate([fvd, ms_fvd.astype(fvd.dtype)], axis=1),
            "ids": np.concatenate([base_ids, diffusive["ids"]]),
            "diffusive": diffusive, "seconds": time.time() - t_start,
            "n_saves": n_s, "dtype": dtype_str, "nel": nel}
