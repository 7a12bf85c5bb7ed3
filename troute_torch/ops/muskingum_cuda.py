"""CUDA kernels for the Muskingum-Cunge secant solve, and their wrapper.

Port of ``troute_tpu/ops/muskingum_pallas.py:muskingum_cunge_pallas``.
Both kernels live in ``troute_torch/csrc/mc_secant.cu`` and run the
reference's scalar control flow per segment, so each lane stops iterating
as soon as it converges.  Results per lane do not depend on the launch
geometry or on which thread solves the lane, so the kernels agree lane for
lane with the plain versions in ``ops/muskingum.py``:

* B1 (``mc_secant``) solves every lane on a persistent grid whose
  converged lanes refill, in batches per warp, from a work counter that
  the wrapper zeroes for each call; plain version ``solve_block``.  With
  ``return_trips`` it also returns each lane's secant trips and residual
  evaluations (int32), as ``solve_block(..., return_trips=True)`` does.
* B2 (``mc_secant_skip``), the block-skip form of strict fixed-point
  sweeps, takes per-lane ``active_rows`` and a previous call's outputs
  ``prev``; a block of ``SKIP_BLOCK`` lanes none of whose lanes is active
  copies ``prev`` through instead of solving.  It runs B1's persistent
  grid and reads a block's flag when a warp claims 32 of its lanes: a
  skipped claim is copied at once, a solved one refills the warp's idle
  lanes as in B1.  Plain version ``solve_block_skip``; ``return_trips``
  gives 0 on skipped lanes.  ``prev`` is read in the order of
  the outputs, (qdc, velc, depthc, ck, cn, X); the TPU wrapper reads it
  with ck and cn swapped (``muskingum_pallas.py:172-173``), which the
  port does not copy.

For CPU tensors the wrapper runs the plain version.  For CUDA tensors it
launches the kernel or raises; nothing falls back.  The TPU wrapper's
``block_sublanes`` has no counterpart here: no solved value depends on the
launch geometry, so the kernels fix it (256 threads per block), and the
skip granularity is ``SKIP_BLOCK`` lanes.  So skip patterns differ from
the TPU wrapper's 2048-lane blocks.
"""

from __future__ import annotations

import ctypes

import torch

from troute_torch import _build
from troute_torch.ops import muskingum as mc

# kernel launches made by this wrapper (the CPU path never counts): B1 in
# LAUNCHES, B2 in SKIP_LAUNCHES
LAUNCHES = 0
SKIP_LAUNCHES = 0

# lanes per activity flag of B2 (kSkipBlock in the source)
SKIP_BLOCK = 256

_N_IN = 13
_SIGNATURES = {torch.float32: ("mc_secant_f32", ctypes.c_float),
               torch.float64: ("mc_secant_f64", ctypes.c_double)}


def _kernel(dtype: torch.dtype, skip: bool):
    name, c_real = _SIGNATURES[dtype]
    if skip:
        name = name.replace("mc_secant", "mc_secant_skip")
    fn = getattr(_build.load("mc_secant"), name)
    if fn.argtypes is None:
        # after dt: 6 outputs, B2's 6 prev and its flags, then the trips,
        # the evaluations and the work counter
        fn.argtypes = ([ctypes.c_void_p] * _N_IN + [c_real]
                       + [ctypes.c_void_p] * (16 if skip else 9)
                       + [ctypes.c_int64, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(args) -> None:
    first = args[0]
    if first.dim() != 1:
        raise ValueError("expected 1-D segment tensors, got "
                         f"{tuple(first.shape)}")
    if first.dtype not in _SIGNATURES:
        raise TypeError(f"unsupported dtype {first.dtype} "
                        "(float32 or float64)")
    for a in args:
        if a.shape != first.shape or a.dtype != first.dtype \
                or a.device != first.device:
            raise ValueError("all segment tensors need one shape, dtype "
                             f"and device; got {tuple(a.shape)} {a.dtype} "
                             f"{a.device} vs {tuple(first.shape)} "
                             f"{first.dtype} {first.device}")
        if not a.is_contiguous():
            raise ValueError("segment tensors must be contiguous")


def block_flags(active_rows: torch.Tensor) -> torch.Tensor:
    """[ceil(n / SKIP_BLOCK)] bool: does any lane of the block move."""
    n = active_rows.shape[0]
    n_blk = -(-n // SKIP_BLOCK)
    act = active_rows.new_zeros(n_blk * SKIP_BLOCK)
    act[:n] = active_rows
    return act.view(n_blk, SKIP_BLOCK).any(dim=1)


def block_active_lanes(active_rows: torch.Tensor) -> torch.Tensor:
    """Per-lane "its block solves" for per-lane "input moved" flags: the
    reduction the skip kernel applies, so callers can track which lanes a
    skip call really recomputed."""
    n = active_rows.shape[0]
    flags = block_flags(active_rows)
    return flags[:, None].expand(-1, SKIP_BLOCK).reshape(-1)[:n]


def muskingum_cunge_cuda(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0,
                         depthp, dt: float, with_diagnostics: bool = True,
                         active_rows=None, prev=None,
                         return_trips: bool = False):
    """One MC timestep for 1-D segment tensors of one shape and dtype.

    ``dt`` is a Python float.  ``with_diagnostics=False`` skips the
    ck/cn/X outputs; they come back as zeros, as from the TPU wrapper.
    ``active_rows`` ([nseg] bool) with ``prev`` (an ``MCOutput`` of the
    same lanes) selects the block-skip kernel B2: a block none of whose
    lanes is active returns ``prev``'s values for its lanes.  The caller
    guarantees that ``active_rows`` marks every lane whose inputs moved
    since the call that produced ``prev``.  ``return_trips`` returns
    ``(MCOutput, trips, evals)``: each lane's int32 secant trips and the
    trips among them that evaluated the residual (both 0 for a lane
    without flow and for a lane that B2 copied through).
    """
    global LAUNCHES, SKIP_LAUNCHES
    args = (qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0, depthp)
    n_out = 6 if with_diagnostics else 3
    skip = active_rows is not None
    if skip != (prev is not None):
        raise ValueError("active_rows and prev go together")
    _check(args + (tuple(prev[:n_out]) if skip else ()))
    if skip and (active_rows.shape != qup.shape
                 or active_rows.dtype != torch.bool
                 or active_rows.device != qup.device):
        raise ValueError("active_rows must be a bool tensor of the segment "
                         "tensors' shape and device")
    if qup.device.type == "cpu":
        if skip:
            out = mc.solve_block_skip(*args, dt=float(dt),
                                      ran=block_active_lanes(active_rows),
                                      prev=prev, return_trips=return_trips)
        else:
            out = mc.solve_block(*args, dt=float(dt),
                                 return_trips=return_trips)
        if return_trips:
            out, trips, evals = out[:6], out[6], out[7]
    elif qup.device.type == "cuda":
        nseg = qup.shape[0]
        out = [torch.empty_like(qup) for _ in range(n_out)]
        trips, evals = ([torch.zeros(nseg, dtype=torch.int32,
                                     device=qup.device) for _ in range(2)]
                        if return_trips else (None, None))
        if nseg:
            ptrs = [o.data_ptr() for o in out] + [None] * (6 - n_out)
            if skip:
                flags = block_flags(active_rows).to(torch.int32)
                ptrs += [p.data_ptr() for p in prev[:n_out]] \
                    + [None] * (6 - n_out) + [flags.data_ptr()]
            # the grid's work counter, zeroed on the launch stream
            counter = torch.zeros(1, dtype=torch.int32, device=qup.device)
            ptrs += [None if c is None else c.data_ptr()
                     for c in (trips, evals)] + [counter.data_ptr()]
            with torch.cuda.device(qup.device):
                stream = torch.cuda.current_stream(qup.device).cuda_stream
                rc = _kernel(qup.dtype, skip)(*[a.data_ptr() for a in args],
                                              float(dt), *ptrs, nseg, stream)
            if rc != 0:
                raise RuntimeError(f"mc_secant{'_skip' if skip else ''} "
                                   f"launch failed: CUDA error {rc}")
            if skip:
                SKIP_LAUNCHES += 1
            else:
                LAUNCHES += 1
    else:
        raise ValueError(f"unsupported device {qup.device}")
    if not with_diagnostics:
        z = torch.zeros_like(qup)
        out = list(out[:3]) + [z, z, z]
    if return_trips:
        return mc.MCOutput(*out), trips, evals
    return mc.MCOutput(*out)
