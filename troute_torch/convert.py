"""Carry the JAX package's inputs and state into the port, and the port's
outputs back to NumPy.

The ``from_*`` functions take the JAX package's NamedTuples (or any
objects with the same fields) and read each field with ``np.array``, so
this module imports no JAX.  Float fields take the given ``dtype``; index
fields become int64; int32 fields (reservoir types, counts, series
indices, months) stay int32; bool fields stay bool.  Every field is
copied, so the tensors never alias JAX's read-only buffers.
``from_hybrid_domain`` and ``from_bmi_state`` carry the host state of the
JAX package's ``HybridDomain`` and BMI instance across;
``from_sharded_inputs`` and ``from_sharded_res_da`` take one rank's row of
the JAX package's [n_dev, ...] sharded arrays.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from troute_torch.diffusive.solver import DiffusiveDomain, DiffusiveState
from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.ops.reservoir_da import (
    GreatLakesDAState, HybridDAState, RfcDAState)
from troute_torch.routing.engine import (
    ChannelParams, GageDA, NetworkArrays, ReservoirDAData, RoutingState)
from troute_torch.routing.upstream_plan import UpstreamOp


def _t(a, *, device, dtype=None) -> torch.Tensor:
    """One field as a tensor: floats in ``dtype``, integers and bools kept
    (int64 and int32 stay as they are)."""
    arr = np.array(a)   # a copy: JAX hands out read-only buffers
    if arr.dtype.kind == "f":
        return torch.as_tensor(arr, dtype=dtype, device=device)
    return torch.as_tensor(arr, device=device)


def _index(a, *, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=torch.int64, device=device)


def _fields(cls, src, *, device, dtype):
    return cls(*[_t(getattr(src, f), device=device, dtype=dtype)
                 for f in cls._fields])


def from_channel_params(cp, *, device, dtype) -> ChannelParams:
    return _fields(ChannelParams, cp, device=device, dtype=dtype)


def from_levelpool_params(lp, *, device, dtype) -> LevelpoolParams:
    return _fields(LevelpoolParams, lp, device=device, dtype=dtype)


def from_network_arrays(net, *, device) -> NetworkArrays:
    """The JAX ``NetworkArrays``, its banded ``UpstreamOp`` and level
    schedule included.  The JAX plan's masks run over the node axis padded
    to a multiple of 1024, whose pad rows carry no edge; they are cut to
    the network's rows, the length the port routes at."""
    uplan = None
    if net.uplan is not None:
        n = np.shape(net.upstream)[0]
        uplan = UpstreamOp.from_arrays(
            np.array(net.uplan.masks[:, :n]), np.array(net.uplan.rem_dst),
            np.array(net.uplan.rem_src), net.uplan.shifts, device=device)
    return NetworkArrays(
        upstream=_index(net.upstream, device=device),
        is_reservoir=_t(net.is_reservoir, device=device),
        res_rows=_index(net.res_rows, device=device),
        uplan=uplan,
        level_nodes=(None if net.level_nodes is None
                     else _index(net.level_nodes, device=device)))


def from_gage_da(da, *, device, dtype) -> GageDA:
    return GageDA(rows=_index(da.rows, device=device),
                  obs=_t(da.obs, device=device, dtype=dtype),
                  lastobs_val=_t(da.lastobs_val, device=device, dtype=dtype),
                  lastobs_time=_t(da.lastobs_time, device=device,
                                  dtype=dtype),
                  decay_coeff=float(da.decay_coeff))


def from_hybrid_state(s, *, device, dtype) -> HybridDAState:
    return _fields(HybridDAState, s, device=device, dtype=dtype)


def from_rfc_state(s, *, device, dtype) -> RfcDAState:
    return _fields(RfcDAState, s, device=device, dtype=dtype)


def from_gl_state(s, *, device, dtype) -> GreatLakesDAState:
    return _fields(GreatLakesDAState, s, device=device, dtype=dtype)


def from_reservoir_da(rd, *, device, dtype) -> ReservoirDAData:
    kw = dict(device=device, dtype=dtype)
    vals = {}
    for f in ReservoirDAData._fields:
        v = getattr(rd, f)
        if f == "hybrid_state0":
            vals[f] = from_hybrid_state(v, **kw)
        elif f == "rfc_state0":
            vals[f] = from_rfc_state(v, **kw)
        elif f == "gl_state0":
            vals[f] = from_gl_state(v, **kw)
        elif f == "obs_lookback_hours":
            vals[f] = float(v)
        elif f == "month_idx":
            vals[f] = _t(v, device="cpu", dtype=dtype)
        else:
            vals[f] = _t(v, **kw)
    return ReservoirDAData(**vals)


def from_routing_state(s, *, device, dtype) -> RoutingState:
    kw = dict(device=device, dtype=dtype)
    return RoutingState(
        *[_t(getattr(s, f), **kw) for f in RoutingState._fields[:5]],
        hybrid=None if s.hybrid is None else from_hybrid_state(s.hybrid, **kw),
        rfc=None if s.rfc is None else from_rfc_state(s.rfc, **kw),
        gl=None if s.gl is None else from_gl_state(s.gl, **kw))


def from_diffusive_domain(dom, *, device, dtype) -> DiffusiveDomain:
    """The JAX ``DiffusiveDomain``: arrays as tensors (None stays None),
    the series timesteps as floats."""
    vals = {}
    for f in DiffusiveDomain._fields:
        v = getattr(dom, f)
        if v is None or isinstance(v, (int, float)):
            vals[f] = None if v is None else float(v)
        elif np.asarray(v).dtype.kind in "iu":
            vals[f] = _index(v, device=device)
        else:
            vals[f] = _t(v, device=device, dtype=dtype)
    return DiffusiveDomain(**vals)


def from_diffusive_state(st, *, device, dtype) -> DiffusiveState:
    return _fields(DiffusiveState, st, device=device, dtype=dtype)


def from_hybrid_domain(jax_hyb):
    """A port ``HybridDomain`` holding a copy of a JAX ``HybridDomain``'s
    state (host NumPy arrays, lists and dicts; no file is read)."""
    from troute_torch.routing.hybrid import HybridDomain
    hyb = HybridDomain.__new__(HybridDomain)
    hyb.__dict__.update(copy.deepcopy(vars(jax_hyb)))
    return hyb


def from_bmi_state(jax_bmi, bmi):
    """Carry a JAX BMI instance (``troute_tpu.bmi.BmiTrouteTpu``) into the
    port's ``bmi`` (a ``BmiTroute`` initialized with the same control
    file, or none): its time, its BMI values, and its routing state
    (``_q``, ``_d``, ``_elev`` in float32, the diffusive ``_dst`` in the
    port's resolved diffusive dtype, the coastal transport series) on
    ``bmi``'s device.  Both build the same network from the same inputs,
    so rows line up.  Returns ``bmi``."""
    bmi._values = {k: np.array(v) for k, v in jax_bmi._values.items()}
    bmi._time = float(jax_bmi._time)
    if not bmi._network_ready:
        bmi._build_network()
    dev = bmi._device
    for f in ("_q", "_d", "_elev"):
        setattr(bmi, f, _t(getattr(jax_bmi, f), device=dev,
                           dtype=torch.float32))
    if getattr(jax_bmi, "_dst", None) is not None:
        dtype = (torch.float32 if bmi._diff_dtype_str == "float32"
                 else torch.float64)
        bmi._dst = from_diffusive_state(jax_bmi._dst, device=dev,
                                        dtype=dtype)
    if getattr(jax_bmi, "_coastal", None) is not None:
        bmi._coastal = copy.deepcopy(jax_bmi._coastal)
    return bmi


def from_sharded_inputs(inp, rank: int, *, device, dtype):
    """Rank ``rank``'s ``ShardedInputs`` from the JAX package's
    ([n_dev, ...] arrays; ``qlat`` [n_cols, n_dev, n_local], the exchange
    rounds ``perm_pairs`` shared): floats in ``dtype``, indices int64,
    masks bool."""
    from troute_torch.parallel.sharded_engine import ShardedInputs

    def row(a):
        return _t(np.array(a)[rank], device=device, dtype=dtype)

    vals = {}
    for f in ShardedInputs._fields:
        v = getattr(inp, f)
        if f == "perm_pairs":
            vals[f] = np.array(v, np.int64)
        elif f == "chan":
            vals[f] = ChannelParams(*[row(a) for a in v])
        elif f == "res_params":
            vals[f] = LevelpoolParams(*[row(a) for a in v])
        elif f == "qlat":
            vals[f] = _t(np.array(v)[:, rank], device=device, dtype=dtype)
        else:
            t = row(v)
            vals[f] = t.long() if t.dtype == torch.int32 else t
    return ShardedInputs(**vals)


def from_sharded_res_da(rda, rank: int, *, device, dtype):
    """Rank ``rank``'s ``ShardedResDA`` from the JAX package's ([n_dev, R,
    ...] lanes; the shared series as replicated [n_dev, ...] copies)."""
    from troute_torch.parallel.sharded_engine import ShardedResDA

    def row(a):
        return _t(np.array(a)[rank], device=device, dtype=dtype)

    states = {"hyb0": HybridDAState, "rfc0": RfcDAState,
              "gl0": GreatLakesDAState}
    vals = {}
    for f in ShardedResDA._fields:
        v = getattr(rda, f)
        if f == "obs_lookback_hours":
            vals[f] = float(v)
        elif f in states:
            vals[f] = states[f](*[row(a) for a in v])
        else:
            vals[f] = row(v)
    return ShardedResDA(**vals)


def to_numpy(x: Any) -> Any:
    """Tensors to NumPy arrays, through NamedTuples, dicts, lists and
    tuples; anything else is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_numpy(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x
