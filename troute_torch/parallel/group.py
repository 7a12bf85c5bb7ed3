"""Process groups for sharded routing: one process per GPU.

The JAX package has one controller that drives every device of its mesh;
here each shard has its own process, and the processes form a
``torch.distributed`` group:

* ``init_group`` joins the group a launcher describes, as ``torchrun``
  does through its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for a rank on the card, gloo on
  the CPU, unless the caller names the backend.  A group that cannot
  start raises; nothing falls back to another backend or to one rank.
* ``spawn_ranks`` starts a group of local processes for tests and
  ``chip_smoke.py``: the ``spawn`` start method (CUDA does not survive
  ``fork``), a rendezvous file in a temporary directory (no TCP port for
  concurrent test workers to race for), and a deadline after which every
  rank is killed and the launcher raises.  Each rank runs ``fn(*args)``
  and returns its result to the launcher; a rank that raises ends the
  group and its traceback is raised in the launcher.  ``fn`` must live in
  a module a rank can import without JAX (``parallel/ranks.py``): a rank
  imports the module of its target.
* ``Comm`` is how one rank's messages travel in its group: the backend
  decides, never a failure, and under gloo with tensors on the card every
  message goes through host memory (gloo sends host tensors only).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

LOG = logging.getLogger(__name__)

# seconds a collective may wait for a rank before the group fails
DEFAULT_TIMEOUT = 600.0


def init_group(device, backend: str | None = None,
               timeout: float = DEFAULT_TIMEOUT, init_method: str = "env://",
               rank: int | None = None, world_size: int | None = None):
    """Create the default process group for this process's ``device`` and
    return it.

    ``backend`` defaults to NCCL for a CUDA device and gloo for the CPU.
    ``init_method`` "env://" reads ``torchrun``'s environment; a
    ``file://`` method needs ``rank`` and ``world_size``.  The group runs
    one collective before it is returned, so a backend that cannot start
    (NCCL without a usable card, two ranks of one NCCL group on one GPU)
    raises here, and the group is destroyed."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if rank is None else dict(rank=rank, world_size=world_size)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timedelta(seconds=timeout), **kw)
    try:
        probe = torch.ones(1, device=device if backend == "nccl" else "cpu")
        dist.all_reduce(probe)
    except Exception:
        dist.destroy_process_group()
        raise
    LOG.info("process group: %s, rank %d of %d on %s", backend,
             dist.get_rank(), dist.get_world_size(), device)
    return dist.group.WORLD


def group_rank(group=None) -> tuple[int, int]:
    """(rank, world size) of this process in ``group`` (None: the default
    group)."""
    return dist.get_rank(group), dist.get_world_size(group)


class Comm:
    """How this rank's messages travel: the group, this rank's place in
    it, and whether tensors on the card go through host memory (a gloo
    group: gloo sends host tensors only)."""

    def __init__(self, group, device):
        self.group = group
        self.rank, self.world = group_rank(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"

    def out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def peer(self, group_rank_: int) -> int:
        """The default group's rank of this group's rank ``group_rank_``
        (point-to-point calls address the default group's ranks)."""
        if self.group is None:
            return group_rank_
        return dist.get_global_rank(self.group, group_rank_)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        src = self.out(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        return [self.back(p) for p in parts]

    def all_max(self, t: torch.Tensor) -> list[float]:
        """Element-wise max over the group, read on the host (one read)."""
        t = self.out(t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t.tolist()

    def describe(self, what: str) -> str:
        how = ("staged through host memory" if self.staged else
               "on the card" if self.device.type == "cuda" else "on the host")
        return f"{what} over {self.backend}, {self.world} ranks, {how}"


def _rank_main(fn, args, rank: int, world_size: int, backend: str,
               device: str, timeout: float, store: str, out: str) -> None:
    torch.set_num_threads(1)
    try:
        init_group(device, backend, timeout, f"file://{store}", rank,
                   world_size)
        result = ("ok", fn(*args))
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    if result[0] == "error":
        # the others may wait in a collective: leave without tearing the
        # group down; the launcher ends them
        os._exit(1)
    dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, backend: str = "gloo", device="cpu",
                timeout: float = 300.0, args: tuple = ()) -> list:
    """Run ``fn(*args)`` in ``world_size`` spawned processes that form a
    ``backend`` group with tensors on ``device``; return their results in
    rank order.  Raises RuntimeError with a rank's traceback if one fails,
    and TimeoutError if the group has not finished in ``timeout`` seconds;
    either way every rank still running is killed."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="troute_ranks_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world_size)]
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, args, r, world_size, backend, str(device), timeout,
                  os.path.join(tmp, "store"), outs[r]))
            for r in range(world_size)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world_size} ranks of {fn.__name__} did not finish "
                        f"in {timeout:.0f} s")
                mp.connection.wait([p.sentinel for p in running], left)
                for p in [p for p in running if p.exitcode is not None]:
                    running.remove(p)
                    if p.exitcode != 0:
                        r = procs.index(p)
                        raise RuntimeError(
                            f"rank {r} of {fn.__name__} failed (exit code "
                            f"{p.exitcode}):\n{_error_of(outs[r])}")
        finally:
            for p in procs:
                if p.pid is None:
                    continue
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f)[1])
        return results


def _error_of(path: str) -> str:
    try:
        with open(path, "rb") as f:
            status, value = pickle.load(f)
    except OSError:
        return "(no result written)"
    return value if status == "error" else "(no error recorded)"
