"""Process groups for the slab-decomposed runtime (PyTorch port of
``isph_tpu/parallel/mesh.py``).

The JAX package runs a sharded step as one SPMD program over a 1-D device
mesh, where ``lax.ppermute`` makes the ring hops and ``lax.psum``/``pmax``
the reductions along the mesh axis named by ``axis_name``.  Here each rank
is a process holding its own slab, and a :class:`Group` stands where JAX
passes ``axis_name``: it wraps a ``torch.distributed`` process group (gloo
across CPU processes, NCCL on the card) and offers the same collectives.

- :func:`make_mesh` starts the process group and returns the :class:`Group`;
- :func:`particle_sharding_spec` is the rank's slice of a particle-minor leaf;
- :func:`spawn` runs a function on ``world`` fresh ranks (the tests and
  ``chip_smoke.py`` use it), each with a deadline.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

# p2p tags of the two ring directions: at world size 2 both hops of a
# halo exchange go to the one peer, and the tags keep them from swapping
_TAG_RIGHT = 11
_TAG_LEFT = 12


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy in a dtype every backend moves (bool as uint8)."""
    t = t.to(torch.uint8) if t.dtype == torch.bool else t
    return t.contiguous().clone()


class Group:
    """The reduction and ring-hop context of one rank: JAX's ``axis_name``,
    over the default ``torch.distributed`` process group.  A sum or max is one ``all_reduce`` of a tensor, whose output carries the
    same bits on every rank, so host decisions taken on it agree.  A ring
    hop is one ``batch_isend_irecv``; at world size 1 it is a local copy,
    as JAX's world-1 ``ppermute`` is the identity (a rank does not send to
    itself)."""

    def __init__(self, rank: int, size: int):
        self.rank = rank
        self.size = size

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the all-rank sum of ``t`` (a new tensor)."""
        out = t.contiguous().clone()
        dist.all_reduce(out.view(-1), op=dist.ReduceOp.SUM)
        return out

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.pmax``: the all-rank maximum of ``t``."""
        out = t.contiguous().clone()
        dist.all_reduce(out.view(-1), op=dist.ReduceOp.MAX)
        return out

    def ring_pair(self, to_right: torch.Tensor, to_left: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both ring hops at once: ``to_right`` goes to rank + 1 and
        ``to_left`` to rank - 1; returns (what the left neighbor sent right,
        what the right neighbor sent left), JAX's
        ``(ppermute(to_right, fwd), ppermute(to_left, bwd))``."""
        if self.size == 1:
            return to_right.clone(), to_left.clone()
        a, b = _wire(to_right), _wire(to_left)
        from_left, from_right = torch.empty_like(a), torch.empty_like(b)
        right, left = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        ops = [dist.P2POp(dist.isend, a, right, tag=_TAG_RIGHT),
               dist.P2POp(dist.irecv, from_left, left, tag=_TAG_RIGHT),
               dist.P2POp(dist.isend, b, left, tag=_TAG_LEFT),
               dist.P2POp(dist.irecv, from_right, right, tag=_TAG_LEFT)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return from_left.to(to_right.dtype), from_right.to(to_left.dtype)

    def ring_shift(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        """One ring hop: +1 sends ``t`` to rank + 1 and returns what rank - 1
        sent (JAX's ``ppermute`` with ``[(i, i + 1)]``); -1 the other way."""
        if shift not in (1, -1):
            raise ValueError(f"ring_shift takes +1 or -1, got {shift}")
        return self.ring_pair(t, t)[0 if shift == 1 else 1]


def make_mesh(world: int, rank: int, *, backend: str, init_file: str,
              timeout: float = 60.0, device: Optional[torch.device] = None) -> Group:
    """Start this rank's process group and return its :class:`Group` (JAX's
    ``make_mesh``: the mesh axis becomes the group).  The store is a file
    (``init_file``, fresh for each group); ``timeout`` bounds the start and
    every later collective, so a rank that skips one fails instead of
    hanging.  ``device`` is the rank's card under NCCL."""
    kw = {}
    if backend == "nccl":
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend=backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return Group(rank=rank, size=world)


def close_mesh() -> None:
    """Tear down the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def particle_sharding_spec(a: torch.Tensor, rank: int, n_loc: int) -> torch.Tensor:
    """Rank ``rank``'s slice of a particle-minor leaf laid out slab by slab
    (JAX's ``particle_sharding_spec`` with the mesh applied): the particle
    axis is the last one, rank r owns slots ``[r n_loc, (r+1) n_loc)``;
    a scalar is replicated."""
    if a.ndim == 0:
        return a
    return a[..., rank * n_loc:(rank + 1) * n_loc]


# the collective timeout of a spawned rank: a rank that skips a collective
# fails after it instead of hanging its peers
RANK_TIMEOUT_S = 60.0


def spawn(fn: Callable, world: int, *args, backend: str = "gloo",
          timeout: float = 240.0) -> list:
    """Run ``fn(group, *args)`` on ``world`` fresh processes, one rank each,
    and return their results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by reference, so it must live in
    an importable module, which is all a rank imports besides this
    package).  Each rank runs with one CPU thread, a process group started
    by :func:`make_mesh` over a file store, and ``RANK_TIMEOUT_S`` on every
    collective; the launcher kills them all at ``timeout`` seconds and
    raises, and raises with the rank's error output when one fails."""
    tmp = tempfile.mkdtemp(prefix="isph_spawn_")
    with open(os.path.join(tmp, "job.pkl"), "wb") as fh:
        pickle.dump((fn, args, backend), fh)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(tmp, f"rank{r}.log"), "wb")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "isph_tpu_torch.parallel._rank", tmp, str(r), str(world)],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            left = deadline - time.monotonic()
            try:
                p.wait(timeout=max(left, 0.0))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"spawned ranks did not finish in {timeout} s "
                                   f"(logs in {tmp})") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{r}.log"), "rb") as fh:
                tail = fh.read().decode(errors="replace")[-4000:]
            raise RuntimeError(f"rank {r} of {world} exited with {p.returncode}:\n{tail}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    shutil.rmtree(tmp, ignore_errors=True)  # a failed group's logs stay
    return out


def run_rank(tmp: str, rank: int, world: int) -> None:
    """The body of one spawned rank (see :func:`spawn`)."""
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "job.pkl"), "rb") as fh:
        fn, args, backend = pickle.load(fh)
    group = make_mesh(world, rank, backend=backend,
                      init_file=os.path.join(tmp, "store"), timeout=RANK_TIMEOUT_S)
    try:
        out = fn(group, *args)
    finally:
        close_mesh()
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)

