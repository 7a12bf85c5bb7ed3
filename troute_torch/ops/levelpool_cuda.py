"""CUDA kernel for the level-pool reservoir step, and its wrapper.

Kernel L1 (``troute_torch/csrc/levelpool.cu``) runs the whole step of
``ops/levelpool.py:levelpool_step`` (three Runge-Kutta stages, four
discharge evaluations) for every lake in one launch, one thread per lake,
in the plain version's order of operations, so that it agrees bit for bit
with the plain version run on the same card.  It replaces the plain
version's ~144 element-wise launches a step, whose host dispatch set the
pace of a step with lakes.  Two forms of the one kernel, chosen by the
arguments:

* ``levelpool_step_cuda(H, qi0, qi1, ql, dt, p)``, the lane form:
  ``levelpool_step`` on lake lanes (``ql`` None reads zeros).  Every
  caller that holds its lakes' inflows goes through it
  (``engine._reservoirs``: the level scan, the strict column sweeps, the
  sharded drivers; the auxiliary reservoir BMI).
* ``levelpool_rows_cuda(H, quc, rows, dt, p, into=None)``, the row form
  of the engine's short step: lake ``i`` reads its inflow ``quc[rows[i]]``
  as both ``qi0`` and ``qi1`` with ``ql`` zero, and with ``into=(q, d)``
  the same launch writes the outflow to ``q[rows]`` and the new elevation
  to ``d[rows]`` in place (and returns the new elevation alone).

For CPU tensors the wrapper runs the plain version (the row form with the
gather and ``index_put_``).  For CUDA tensors it launches the kernel on
the current stream or raises; nothing falls back.  The kernel reads the
nine parameters packed [n, 9]: the wrapper checks and packs a parameter
set once, keeps the 64 used last, and packs again only after one of its
tensors was written in place.  Per call it checks the tensors that change
each step, allocates only the outputs it returns and never synchronises.
"""

from __future__ import annotations

import ctypes

import torch

from troute_torch import _build
from troute_torch.ops.levelpool import LevelpoolParams, levelpool_step
from troute_torch.tracing import count

# kernel launches made by this wrapper (the CPU path never counts)
LAUNCHES = 0

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
