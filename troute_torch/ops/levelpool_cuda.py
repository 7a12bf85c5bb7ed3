"""CUDA kernel for the level-pool reservoir step, with or without the typed
reservoir DA, and its wrappers.

Kernel L1 (``troute_torch/csrc/levelpool.cu``) runs the whole step of
``ops/levelpool.py:levelpool_step`` (three Runge-Kutta stages, four
discharge evaluations) for every lake in one launch, one thread per lake,
in the plain version's order of operations, so that it agrees bit for bit
with the plain version run on the same card.  It replaces the plain
version's ~144 element-wise launches a step, whose host dispatch set the
pace of a step with lakes.  Its forms, chosen by the arguments:

* ``levelpool_step_cuda(H, qi0, qi1, ql, dt, p)``, the lane form:
  ``levelpool_step`` on lake lanes (``ql`` None reads zeros).  Every
  caller without DA that holds its lakes' inflows goes through it
  (``engine._reservoirs``: the level scan, the strict column sweeps, the
  sharded drivers; the auxiliary reservoir BMI).
* ``levelpool_rows_cuda(H, quc, rows, dt, p, into=None)``, the row form
  of the engine's short step: lake ``i`` reads its inflow ``quc[rows[i]]``
  as both ``qi0`` and ``qi1`` with ``ql`` zero, and with ``into=(q, d)``
  the same launch writes the outflow to ``q[rows]`` and the new elevation
  to ``d[rows]`` in place (and returns the new elevation alone).
* ``levelpool_da_rows_cuda`` and ``levelpool_da_step_cuda``, the DA form
  in the row form (the short step) and the lane form (``engine.
  _reservoirs``): the level pool, then each lake's own kind of
  ``ops/reservoir_da.py:typed_reservoir_dispatch`` on its result, and the
  scatter, in one launch, in place of the plain dispatch's ~190 launches
  over every lake.

For CPU tensors the wrappers run the plain versions (the row forms with
the gather and ``index_put_``).  For CUDA tensors they launch the kernel
on the current stream or raise; nothing falls back.  The kernel reads the
nine parameters packed [n, 9]: the wrapper checks and packs a parameter
set once, keeps the 64 used last, and packs again only after one of its
tensors was written in place.  The DA inputs that stay fixed over a
routing call (types, RFC counts and flags, observation and series
matrices) are checked once per DA data object in the same way, keeping
only the one used last, and the kernel reads them through one struct of
pointers and strides.  Per call
a wrapper checks the tensors that change each step, allocates only the
outputs it returns and never synchronises.
"""

from __future__ import annotations

import ctypes

import torch

from troute_torch import _build
from troute_torch.ops.levelpool import LevelpoolParams, levelpool_step
from troute_torch.ops.reservoir_da import (GreatLakesDAState, HybridDAState,
                                           RfcDAState,
                                           typed_reservoir_dispatch)
from troute_torch.tracing import count

# kernel launches made by these wrappers, every form (the CPU path never
# counts), and those of the DA form alone
LAUNCHES = 0
DA_LAUNCHES = 0

_SIGNATURES = {torch.float32: ("levelpool_f32", ctypes.c_float),
               torch.float64: ("levelpool_f64", ctypes.c_double)}

# id(params) -> (params, the version counters of its tensors, [n, 9]),
# the most recently used last; the level scan keeps one set per level row
# with lakes
_PACKED: dict[int, tuple] = {}
_PACKED_KEEP = 64


def _kernel(dtype: torch.dtype):
    name, c_real = _SIGNATURES[dtype]
    fn = getattr(_build.load("levelpool"), name)
    if fn.argtypes is None:
        # H, qi0, qi1, ql, rows, quc, params; dt; outflow, h_new, inflow,
        # q_into, d_into; lakes, nodes, stream
        fn.argtypes = ([ctypes.c_void_p] * 7 + [c_real]
                       + [ctypes.c_void_p] * 5
                       + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(lanes, nodes=()) -> None:
    """``lanes``: contiguous [n] tensors of one dtype and device;
    ``nodes``: contiguous 1-D tensors of the node axis, the same."""
    first = lanes[0]
    if first.dim() != 1:
        raise ValueError(f"expected 1-D lake tensors, got {tuple(first.shape)}")
    if first.dtype not in _SIGNATURES:
        raise TypeError(f"unsupported dtype {first.dtype} "
                        "(float32 or float64)")
    for a in (*lanes, *nodes):
        if a.dtype != first.dtype or a.device != first.device:
            raise ValueError("all tensors need one dtype and device; got "
                             f"{a.dtype} {a.device} vs {first.dtype} "
                             f"{first.device}")
        if a.dim() != 1 or not a.is_contiguous():
            raise ValueError("lake and node tensors must be 1-D and "
                             "contiguous")
    for a in lanes:
        if a.shape != first.shape:
            raise ValueError(f"lake tensors of shapes {tuple(a.shape)} and "
                             f"{tuple(first.shape)}")


def _check_params(p: LevelpoolParams, H) -> None:
    """``p``'s fields need the shape, dtype and device of the lakes' ``H``."""
    for c in p:
        if c.dtype != H.dtype or c.device != H.device \
                or c.shape != H.shape:
            raise ValueError("level-pool parameters need the lakes' shape, "
                             f"dtype and device; got {tuple(c.shape)} "
                             f"{c.dtype} {c.device} vs {tuple(H.shape)} "
                             f"{H.dtype} {H.device}")


def _packed(p: LevelpoolParams, H) -> torch.Tensor:
    """``p``'s nine fields as one contiguous [n, 9] tensor, checked against
    ``H`` when packed; a kept one is checked by its shape, dtype and
    device alone."""
    versions = tuple(c._version for c in p)
    hit = _PACKED.get(id(p))
    if hit is not None and hit[0] is p and hit[1] == versions:
        packed = hit[2]
        if packed.shape[0] == H.shape[0] and packed.dtype == H.dtype \
                and packed.device == H.device:
            _PACKED[id(p)] = _PACKED.pop(id(p))
            return packed
    _check_params(p, H)
    packed = torch.stack(tuple(p), dim=1)
    if len(_PACKED) >= _PACKED_KEEP:
        del _PACKED[next(iter(_PACKED))]
    _PACKED[id(p)] = (p, versions, packed)
    return packed


def _ptr(a) -> int | None:
    return None if a is None else a.data_ptr()


def _launch(H, qi0, qi1, ql, rows, quc, p: LevelpoolParams, dt: float,
            outs, n_nodes: int) -> None:
    global LAUNCHES
    n = H.shape[0]
    params = _packed(p, H)
    if n == 0:
        return
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        rc = _kernel(H.dtype)(
            *[_ptr(a) for a in (H, qi0, qi1, ql, rows, quc, params)],
            float(dt), *[_ptr(o) for o in outs], n, n_nodes, stream)
    if rc != 0:
        raise RuntimeError(f"levelpool launch failed: CUDA error {rc}")
    LAUNCHES += 1
    count("engine.levelpool_launches")


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _check_rows(H, quc, rows, into) -> None:
    """The row form's node tensors: ``rows`` int64 of the lakes' shape and
    device, ``quc`` and the ``into`` pair (or None) 1-D and contiguous, of
    the lakes' dtype and device, the pair of ``quc``'s shape and sharing
    no memory with each other or with ``quc``."""
    nodes = (quc,) if into is None else (quc, *into)
    _check((H,), nodes)
    if rows.dim() != 1 or rows.shape != H.shape \
            or rows.dtype != torch.int64 or rows.device != H.device \
            or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous int64 tensor of the "
                         "lakes' shape and device")
    if into is not None:
        for a in into:
            if a.shape != quc.shape:
                raise ValueError(f"into tensor of shape {tuple(a.shape)} "
                                 f"for nodes of shape {tuple(quc.shape)}")
        if any(a.untyped_storage().data_ptr()
               == b.untyped_storage().data_ptr()
               for a, b in ((into[0], into[1]), (into[0], quc),
                            (into[1], quc))):
            raise ValueError("into tensors must not share memory with each "
                             "other or with quc")


def levelpool_step_cuda(H, qi0, qi1, ql, dt: float, p: LevelpoolParams):
    """``levelpool_step`` on 1-D lake tensors of one shape, dtype and
    device (``ql`` None reads zeros).  Returns (outflow, new_H)."""
    _check((H, qi0, qi1) + (() if ql is None else (ql,)))
    if _device_type(H) == "cpu":
        _check_params(p, H)
        return levelpool_step(H, qi0, qi1,
                              torch.zeros_like(qi0) if ql is None else ql,
                              dt, p)
    outflow, h_new = torch.empty_like(H), torch.empty_like(H)
    _launch(H, qi0, qi1, ql, None, None, p, dt,
            (outflow, h_new, None, None, None), 0)
    return outflow, h_new


def levelpool_rows_cuda(H, quc, rows, dt: float, p: LevelpoolParams,
                        into=None):
    """The level pool of the lakes at node rows ``rows`` (int64 [n]), each
    with inflow ``quc[rows]`` as both ``qi0`` and ``qi1`` and no lateral
    inflow.  Returns (outflow, new_H, inflow) on the lake lanes.  With
    ``into=(q, d)``, node tensors of ``quc``'s shape that share no memory
    with it, writes ``q[rows] = outflow`` and ``d[rows] = new_H`` in place
    instead and returns new_H alone."""
    _check_rows(H, quc, rows, into)
    if _device_type(H) == "cpu":
        _check_params(p, H)
        inflow = quc[rows]
        outflow, h_new = levelpool_step(H, inflow, inflow,
                                        torch.zeros_like(inflow), dt, p)
        if into is None:
            return outflow, h_new, inflow
        into[0].index_put_((rows,), outflow)
        into[1].index_put_((rows,), h_new)
        return h_new
    h_new = torch.empty_like(H)
    if into is None:
        outflow, inflow = torch.empty_like(H), torch.empty_like(H)
        _launch(H, None, None, None, rows, quc, p, dt,
                (outflow, h_new, inflow, None, None), quc.shape[0])
        return outflow, h_new, inflow
    _launch(H, None, None, None, rows, quc, p, dt,
            (None, h_new, None, *into), quc.shape[0])
    return h_new


# ---------------------------------------------------------------- typed DA

_DA_SIGNATURES = {torch.float32: ("levelpool_da_f32", ctypes.c_float),
                  torch.float64: ("levelpool_da_f64", ctypes.c_double)}

_P, _I = ctypes.c_void_p, ctypes.c_int64


class _DAInputs(ctypes.Structure):
    """``DAInputs`` of ``csrc/levelpool.cu``, field for field."""

    _fields_ = [
        ("wbody_type", _P), ("rfc_counts", _P), ("rfc_use", _P),
        ("rfc_timestep", _P), ("rfc_persist", _P),
        ("hyb_obs", _P), ("hyb_obs_s0", _I), ("hyb_obs_s1", _I),
        ("hyb_time", _P), ("hyb_time_s", _I), ("n_hobs", _I),
        ("rfc_series", _P), ("rfc_s0", _I), ("rfc_s1", _I), ("n_counts", _I),
        ("gl_obs", _P), ("gl_obs_s0", _I), ("gl_obs_s1", _I),
        ("gl_time", _P), ("gl_time_s0", _I), ("gl_time_s1", _I),
        ("n_gobs", _I),
        ("gl_clim", _P), ("clim_s0", _I), ("clim_s1", _I),
        ("lookback_s", ctypes.c_double)]


# the fields of a ReservoirDAData that the kernel reads: lane vectors (with
# the dtype each is read in, None the lakes'), then matrices
_DA_LANES = (("wbody_type", torch.int32), ("rfc_counts", torch.int32),
             ("rfc_use", torch.bool), ("rfc_timestep", None),
             ("rfc_persist_seconds", None))
_DA_MATRICES = ("hybrid_obs", "rfc_series", "gl_obs", "gl_obs_time",
                "gl_climatology")
_DA_FIELDS = (tuple(f for f, _ in _DA_LANES) + _DA_MATRICES
              + ("hybrid_obs_time",))

# the DA data packed last: (res_da, the version counters of its tensors,
# the lakes' count, dtype and device, (DAInputs, month count), the tensors
# the DAInputs point into); one only, so that a finished hour's inputs are
# freed once the next hour's are packed
_DA_LAST: tuple | None = None


def _da_kernel(dtype: torch.dtype):
    name, c_real = _DA_SIGNATURES[dtype]
    fn = getattr(_build.load("levelpool"), name)
    if fn.argtypes is None:
        # H, inflow, rows, quc, params; dt; now; month; DAInputs; the nine
        # states in; st_out, ts_out, h_new, outflow, d_scat, q_into,
        # d_into; lakes, nodes, stream
        fn.argtypes = ([_P] * 5 + [c_real, ctypes.c_double, _I,
                                   ctypes.POINTER(_DAInputs)]
                       + [_P] * 16 + [_I, _I, _P])
        fn.restype = ctypes.c_int
    return fn


def _da_tensors(res_da, H) -> dict:
    """``res_da``'s fields that the kernel reads, checked against the
    lakes' ``H``: the lane vectors [n] on its device, the types and RFC
    counts integers and the RFC flags booleans (read as int32 and bool:
    converted when they are not), the RFC time step and persist seconds
    of ``H``'s dtype, all contiguous; the observation, series, time and
    climatology matrices [n, >= 1] of ``H``'s dtype and device, the Great
    Lakes' times of their observations' shape, and ``hybrid_obs_time``
    one per column of ``hybrid_obs``.  Raises on anything else."""
    n, dtype, device = H.shape[0], H.dtype, H.device
    out = {}
    for f, kind in _DA_LANES:
        a = getattr(res_da, f)
        if a.shape != (n,) or a.device != device \
                or (kind is None and a.dtype != dtype) \
                or (kind is not None and a.dtype.is_floating_point):
            raise ValueError(f"res_da.{f}: {tuple(a.shape)} {a.dtype} "
                             f"{a.device} for {n} lakes of {dtype} on "
                             f"{device}")
        out[f] = a.to(kind or dtype).contiguous()
    for f in _DA_MATRICES:
        a = getattr(res_da, f)
        if a.dim() != 2 or a.shape[0] != n or a.shape[1] < 1 \
                or a.dtype != dtype or a.device != device:
            raise ValueError(f"res_da.{f}: {tuple(a.shape)} {a.dtype} "
                             f"{a.device}, expected [{n}, >= 1] {dtype} "
                             f"on {device}")
        out[f] = a
    t = res_da.hybrid_obs_time
    if t.shape != res_da.hybrid_obs.shape[1:] or t.dtype != dtype \
            or t.device != device:
        raise ValueError(f"res_da.hybrid_obs_time: {tuple(t.shape)} "
                         f"{t.dtype} {t.device} for hybrid_obs "
                         f"{tuple(res_da.hybrid_obs.shape)}")
    if res_da.gl_obs_time.shape != res_da.gl_obs.shape:
        raise ValueError("res_da.gl_obs_time needs gl_obs's shape")
    out["hybrid_obs_time"] = t
    return out


def _da_packed(res_da, H) -> tuple:
    """(``DAInputs``, month count) of ``res_da`` for the lakes ``H``,
    checked and packed once per DA data object, as ``_packed`` packs a
    parameter set: packed again for another object, for lakes of another
    count, dtype or device, or after one of its tensors was written in
    place."""
    global _DA_LAST
    versions = tuple(getattr(res_da, f)._version for f in _DA_FIELDS)
    lakes = (H.shape[0], H.dtype, H.device)
    hit = _DA_LAST
    if hit is not None and hit[0] is res_da and hit[1] == versions \
            and hit[2] == lakes:
        return hit[3]
    t = _da_tensors(res_da, H)
    hobs, series, gobs = t["hybrid_obs"], t["rfc_series"], t["gl_obs"]
    gtime, clim = t["gl_obs_time"], t["gl_climatology"]
    da = _DAInputs(
        *[t[f].data_ptr() for f, _ in _DA_LANES],
        hobs.data_ptr(), *hobs.stride(),
        t["hybrid_obs_time"].data_ptr(), t["hybrid_obs_time"].stride(0),
        hobs.shape[1],
        series.data_ptr(), *series.stride(), series.shape[1],
        gobs.data_ptr(), *gobs.stride(),
        gtime.data_ptr(), *gtime.stride(), gobs.shape[1],
        clim.data_ptr(), *clim.stride(),
        float(res_da.obs_lookback_hours) * 3600.0)
    _DA_LAST = (res_da, versions, lakes, (da, clim.shape[1]), t)
    return da, clim.shape[1]


def _month(month_i, months: int) -> int:
    """``month_i`` as a column of a climatology of ``months`` columns, as
    Python indexes (a negative index counts from the end)."""
    m = int(month_i)
    if not -months <= m < months:
        raise IndexError(f"month index {month_i} for a climatology of "
                         f"{months} months")
    return m % months


def _state_ptrs(states, H) -> tuple[list, list]:
    """The pointers of the nine fields of ``states`` (hybrid, RFC, Great
    Lakes DA states) in the kernel's order (the RFC series index fifth),
    and the tensors they point into.  Each field is [n] on the lakes'
    device, the index of an integer type (read as int32), the others of
    the lakes' dtype; a field that is not contiguous, or not int32 for the
    index, is copied.  The caller's tensors are never written."""
    hyb, rfc, gl = states
    fields = (*hyb, rfc.timeseries_idx, rfc.update_time, *gl)
    shape, dtype, device = H.shape, H.dtype, H.device
    keep = []
    for k, a in enumerate(fields):
        index = k == 4
        if a.shape != shape or a.device != device \
                or (a.dtype.is_floating_point if index else a.dtype != dtype):
            raise ValueError(f"DA state field {k}: {tuple(a.shape)} "
                             f"{a.dtype} {a.device} for lakes "
                             f"{tuple(shape)} {dtype} {device}")
        keep.append((a.to(torch.int32) if index else a).contiguous())
    return [a.data_ptr() for a in keep], keep


def _launch_da(H, inflow, rows, quc, p: LevelpoolParams, dt: float, res_da,
               states, now: float, month_i, into) -> tuple:
    """One launch of the DA form, the lane form (``inflow``) or the row
    form (``rows`` into ``quc``, scattering into ``into``).  Returns (out,
    ts): ``out`` [9, n] (lane form [11, n]) of the lakes' dtype, the eight
    float DA state fields in the kernel's order, the elevation (then the
    outflow and the depth column's value), and ``ts`` the int32 RFC series
    index."""
    global LAUNCHES, DA_LAUNCHES
    n = H.shape[0]
    params = _packed(p, H)
    da, months = _da_packed(res_da, H)
    month = _month(month_i, months)
    # _keep holds any copies the pointers point into through the launch
    ptrs, _keep = _state_ptrs(states, H)
    out = H.new_empty((11 if rows is None else 9, n))
    ts = torch.empty(n, dtype=torch.int32, device=H.device)
    if n == 0:
        return out, ts
    base, row = out.data_ptr(), n * out.element_size()
    o = [base + k * row for k in range(out.shape[0])]
    scatter = (None, None) if rows is None else (_ptr(into[0]), _ptr(into[1]))
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        rc = _da_kernel(H.dtype)(
            *[_ptr(a) for a in (H, inflow, rows, quc, params)], float(dt),
            float(now), month, ctypes.byref(da), *ptrs, o[0], ts.data_ptr(),
            o[8], *(o[9:11] if rows is None else (None, None)), *scatter, n,
            0 if quc is None else quc.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"levelpool DA launch failed: CUDA error {rc}")
    LAUNCHES += 1
    DA_LAUNCHES += 1
    count("engine.levelpool_launches")
    count("engine.reservoir_da_launches")
    return out, ts


def _da_states(v, ts) -> tuple:
    """(hybrid, RFC, Great Lakes) DA states from the rows ``v`` of a DA
    launch's output and its RFC index ``ts``."""
    return (HybridDAState(*v[:4]), RfcDAState(ts, v[4]),
            GreatLakesDAState(*v[5:8]))


def _plain_da(H, inflow, dt: float, p: LevelpoolParams, res_da, states,
              now: float, month_i):
    """The plain level pool at inflow ``inflow`` (as both ``qi0`` and
    ``qi1``, no lateral inflow), then ``typed_reservoir_dispatch``:
    (outflow, elevation, the depth column's value, DA states)."""
    _check_params(p, H)
    lp_out, lp_elev = levelpool_step(H, inflow, inflow,
                                     torch.zeros_like(inflow), dt, p)
    hyb, rfc, gl = states
    outflow, elev, d_scat, hyb, rfc, gl = typed_reservoir_dispatch(
        res_da.wbody_type, res_da.hybrid_obs, res_da.hybrid_obs_time, hyb,
        res_da.rfc_series, res_da.rfc_counts, res_da.rfc_use,
        res_da.rfc_timestep, res_da.rfc_persist_seconds, rfc,
        res_da.gl_obs, res_da.gl_obs_time, res_da.gl_climatology, gl,
        res_da.obs_lookback_hours, H, inflow, lp_out, lp_elev, now, month_i,
        p.area, p.max_depth, p.orifice_elev, dt)
    return outflow, elev, d_scat, (hyb, rfc, gl)


def levelpool_da_step_cuda(H, inflow, dt: float, p: LevelpoolParams, res_da,
                           states, now: float, month_i):
    """The lane form with the typed reservoir DA: the level pool of lakes
    with inflow ``inflow`` as both ``qi0`` and ``qi1`` and no lateral
    inflow, then each lake's kind of ``typed_reservoir_dispatch``
    (``res_da`` a ``ReservoirDAData`` or an object with its fields,
    ``states`` the (hybrid, RFC, Great Lakes) DA states, ``now`` the time
    in s, ``month_i`` the climatology's month index).  Returns (outflow,
    elevation, the depth column's value, new DA states)."""
    _check((H, inflow))
    if _device_type(H) == "cpu":
        return _plain_da(H, inflow, dt, p, res_da, states, now, month_i)
    out, ts = _launch_da(H, inflow, None, None, p, dt, res_da, states, now,
                         month_i, None)
    v = out.unbind(0)
    return v[9], v[8], v[10], _da_states(v, ts)


def levelpool_da_rows_cuda(H, quc, rows, dt: float, p: LevelpoolParams,
                           res_da, states, now: float, month_i, *, into):
    """The row form with the typed reservoir DA: the lakes at node rows
    ``rows`` see the inflow ``quc[rows]``, as in ``levelpool_rows_cuda``,
    and then run ``levelpool_da_step_cuda``'s DA; with ``into=(q, d)``
    (as there) the outflow goes to ``q[rows]`` and the depth column's
    value to ``d[rows]``, in place.  Returns (elevation, new DA
    states)."""
    if into is None:
        raise ValueError("the DA row form scatters into into=(q, d)")
    _check_rows(H, quc, rows, into)
    if _device_type(H) == "cpu":
        outflow, elev, d_scat, states = _plain_da(
            H, quc[rows], dt, p, res_da, states, now, month_i)
        into[0].index_put_((rows,), outflow)
        into[1].index_put_((rows,), d_scat)
        return elev, states
    out, ts = _launch_da(H, None, rows, quc, p, dt, res_da, states, now,
                         month_i, into)
    v = out.unbind(0)
    return v[8], _da_states(v, ts)
