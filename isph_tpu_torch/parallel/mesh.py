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
    over the default ``torch.distributed`` process group.  A sum or max is
    one ``all_reduce`` of a tensor, whose output carries the same bits on
    every rank, so host decisions taken on it agree.  A ring hop is one
    ``batch_isend_irecv``; at world size 1 it is a local copy, as JAX's
    world-1 ``ppermute`` is the identity (a rank does not send to itself).

    ``device`` is the rank's card under NCCL (None on gloo).  The counters
    count what the rank did since they were last set to 0 (:meth:`reset`):
    ``allreduces`` the ``psum``/``pmax`` calls, ``ring_hops`` the messages
    sent to a neighbor and ``ring_bytes`` their payload (0 at world size 1,
    where a hop is a local copy), the quantities ``scripts/weak_scaling.py``
    counts in JAX's compiled program."""

    def __init__(self, rank: int, size: int, device: Optional[torch.device] = None):
        self.rank = rank
        self.size = size
        self.device = device
        self.reset()

    def reset(self) -> None:
        """Set the counters to 0."""
        self.allreduces = 0
        self.ring_hops = 0
        self.ring_bytes = 0

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        out = t.contiguous().clone()
        dist.all_reduce(out.view(-1), op=op)
        self.allreduces += 1
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the all-rank sum of ``t`` (a new tensor)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.pmax``: the all-rank maximum of ``t``."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def _hops(self, sends) -> list:
        """Post every hop of ``sends``, ``(payload, dst, src, tag)`` each:
        the payload goes to rank ``dst`` and a tensor of its shape comes
        from rank ``src`` under the same tag.  Returns the received tensors
        in ``sends``' order, in the payloads' dtypes."""
        ops, recv = [], []
        for payload, dst, src, tag in sends:
            a = _wire(payload)
            r = torch.empty_like(a)
            ops += [dist.P2POp(dist.isend, a, dst, tag=tag),
                    dist.P2POp(dist.irecv, r, src, tag=tag)]
            recv.append(r)
            self.ring_hops += 1
            self.ring_bytes += a.numel() * a.element_size()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [r.to(p[0].dtype) for r, p in zip(recv, sends)]

    def ring_pair(self, to_right: torch.Tensor, to_left: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both ring hops at once: ``to_right`` goes to rank + 1 and
        ``to_left`` to rank - 1; returns (what the left neighbor sent right,
        what the right neighbor sent left), JAX's
        ``(ppermute(to_right, fwd), ppermute(to_left, bwd))``."""
        if self.size == 1:
            self.ring_hops += 2
            return to_right.clone(), to_left.clone()
        right, left = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        from_left, from_right = self._hops([(to_right, right, left, _TAG_RIGHT),
                                            (to_left, left, right, _TAG_LEFT)])
        return from_left, from_right

    def ring_shift(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        """One ring hop: +1 sends ``t`` to rank + 1 and returns what rank - 1
        sent (JAX's ``ppermute`` with ``[(i, i + 1)]``); -1 the other way."""
        if shift not in (1, -1):
            raise ValueError(f"ring_shift takes +1 or -1, got {shift}")
        if self.size == 1:
            self.ring_hops += 1
            return t.clone()
        dst, src = (self.rank + shift) % self.size, (self.rank - shift) % self.size
        return self._hops([(t, dst, src, _TAG_RIGHT if shift == 1 else _TAG_LEFT)])[0]


def make_mesh(world: int, rank: int, *, backend: str, init_file: str,
              timeout: float = 60.0, device: Optional[torch.device] = None) -> Group:
    """Start this rank's process group and return its :class:`Group` (JAX's
    ``make_mesh``: the mesh axis becomes the group).  The store is a file
    (``init_file``, fresh for each group); ``timeout`` bounds the start and
    every later collective, so a rank that skips one fails instead of
    hanging.  ``device`` is the rank's card under NCCL (by default the
    current one), and the group's ``device``."""
    kw = {}
    if backend == "nccl":
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend=backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return Group(rank=rank, size=world, device=kw.get("device_id"))


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
    raises, and raises with the rank's error output when one fails.  Under
    NCCL rank r runs on card r, so ``world`` may not exceed the cards."""
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"{world} NCCL ranks need {world} cards, this machine has "
                         f"{torch.cuda.device_count()}")
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
    device = torch.device("cuda", rank) if backend == "nccl" else None
    group = make_mesh(world, rank, backend=backend, init_file=os.path.join(tmp, "store"),
                      timeout=RANK_TIMEOUT_S, device=device)
    try:
        out = fn(group, *args)
    finally:
        close_mesh()
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)

