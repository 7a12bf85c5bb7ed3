"""The port's diffusive solver (``troute_torch/diffusive``) against the
scalar reference oracle (``tests/reference_diffusive.py``), its two save
forms against each other, and f32 against f64.

Tolerances: against the oracle rtol 1e-8 (``tests/test_diffusive_parity.py``'s
bar), 1e-4 for the Jacobi corrector (its 1e-6 m sweep tolerance); the
"host" and "device" save forms the same bits; f32 against f64 max relative
discharge error < 1e-4 and surface error < 1e-3 m
(``tests/test_diffusive_parity.py:299-332``).
"""

import numpy as np
import pytest
import torch

from troute_torch import convert
from troute_torch.diffusive import domain as tdomain
from troute_torch.diffusive import solver as tsolver

from reference_diffusive import ReferenceDiffusive
from test_diffusive_parity import (_network_fixture,
                                   _oracle_tables_from_domain, _prism_reach)
from test_torch_diffusive import CPU, DT, _close, _np, _q0

torch.set_num_threads(1)


def test_device_dispatch_matches_host():
    """The "device" saves (fixed slots, the last forced to the final
    state) equal the "host" saves where both land on the boundaries."""
    r = _prism_reach(n_nodes=12, dx=1500.0)
    nts = 12
    dom = tdomain.build_domain([r], [-1], np.zeros((nts, 1, 12)), DT,
                               np.full((nts, 1), 120.0), DT, DT, **CPU)
    q0 = torch.full((1, dom.n_cols), 120.0, dtype=torch.float64)
    res = {}
    for disp in ("host", "device"):
        st = tsolver.initialize_state(dom, q0, dtini_min=30.0)
        res[disp] = tsolver.run_diffusive(dom, st, 3600.0, DT,
                                          dispatch=disp)
    assert len(res["host"][1]) == len(res["device"][1]) == 12
    for (t1, q1, y1), (t2, q2, y2) in zip(res["host"][1], res["device"][1]):
        assert t1 == pytest.approx(t2, abs=1e-9)
        assert torch.equal(q1, q2) and torch.equal(y1, y2)
    assert torch.equal(res["host"][0].y, res["device"][0].y)


# ------------------------------------------------------ against the oracle

def _oracle_case(mode, coastal=False, dispatch="host"):
    if coastal:
        nts = 24
        r = _prism_reach(n_nodes=7, s0=3e-4, z0=10.0)
        reaches, ds = [r], [-1]
        qlat = np.zeros((nts, 1, 7))
        trib = np.full((nts, 1), 60.0)
        db = (2.5 + 0.8 * np.sin(np.arange(5) / 2.0))[None, :]
        kw = dict(db_depth=db, dt_db=3600.0)
        values = [60.0]
    else:
        reaches, ds, qlat, trib, _ = _network_fixture()
        kw, values = {}, [60.0, 40.0, 100.0]
    dom = tdomain.build_domain(reaches, ds, qlat, DT, trib, DT, DT, **CPU,
                               **kw)
    tabs, z_adj = _oracle_tables_from_domain(convert.to_numpy(dom))
    ref_kw = dict(dsbc_option=1, **kw) if coastal else {}
    ref = ReferenceDiffusive(reaches, ds, qlat, DT, trib, DT, DT, tabs=tabs,
                             z_adj=z_adj, **ref_kw)
    q0 = _q0(dom, values)
    st = tsolver.initialize_state(dom, torch.as_tensor(q0), DT / 10.0,
                                  corrector_mode=mode)
    ref_state = ref.initialize(q0)
    st, saves = tsolver.run_diffusive(dom, st, 2 * 3600.0, DT,
                                      corrector_mode=mode, dispatch=dispatch)
    ref_saves = ref.run(ref_state, 2 * 3600.0, DT)
    return dom, st, saves, ref_saves, ref_state


@pytest.mark.parametrize("mode, coastal, dispatch, rtol", [
    ("wavefront", False, "host", 1e-8), ("wavefront", True, "host", 1e-8),
    ("wavefront", False, "device", 1e-8), ("jacobi", False, "host", 1e-4)])
def test_run_matches_oracle(mode, coastal, dispatch, rtol):
    dom, st, saves, ref_saves, ref_state = _oracle_case(mode, coastal,
                                                        dispatch)
    C = dom.n_cols
    ncomp = _np(dom.ncomp)
    assert len(saves) == len(ref_saves)
    for (t1, q1, y1), (t2, q2, y2) in zip(saves, ref_saves):
        assert abs(t1 - t2) < 1e-6
        for j in range(dom.n_reaches):
            s = slice(C - ncomp[j], C)
            _close(_np(q1)[j, s], q2[j], rtol=rtol, atol=rtol,
                   what=f"q reach {j} t={t1}")
            _close(_np(y1)[j, s], y2[j], rtol=rtol, atol=rtol,
                   what=f"y reach {j} t={t1}")
    if mode == "wavefront" and not coastal:
        for j in range(dom.n_reaches):
            assert float(st.celerity[j, C - 1]) == pytest.approx(
                ref_state["cel"][j][0], rel=1e-8)


def test_float32_tolerance():
    """f32 against f64, Jacobi corrector, 48 steps on the junction
    fixture: ``tests/test_diffusive_parity.py:299-332``'s bounds."""
    reaches, ds, qlat, trib, dt = _network_fixture(nts=48)
    out = {}
    for dtype in (torch.float64, torch.float32):
        dom = tdomain.build_domain(reaches, ds, qlat, dt, trib, dt, dt,
                                   device="cpu", dtype=dtype)
        q0 = torch.full((3, 8), 50.0, dtype=dtype)
        st = tsolver.initialize_state(dom, q0, dt / 10.0,
                                      corrector_mode="jacobi")
        _, out[dtype] = tsolver.run_diffusive(dom, st, 48 * dt, dt,
                                              corrector_mode="jacobi",
                                              dispatch="host")
    v = _np(dom.valid)
    max_rq = max_dy = 0.0
    for (_, q64, y64), (_, q32, y32) in zip(out[torch.float64],
                                            out[torch.float32]):
        q64, y64 = _np(q64), _np(y64)
        q32, y32 = _np(q32).astype(np.float64), _np(y32).astype(np.float64)
        rq = np.abs(q32 - q64)[v] / np.maximum(np.abs(q64[v]), 1e-6)
        max_rq = max(max_rq, rq.max())
        max_dy = max(max_dy, np.abs(y32 - y64)[v].max())
    assert max_rq < 1e-4, max_rq
    assert max_dy < 1e-3, max_dy
