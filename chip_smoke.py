#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (isph_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device: require a CUDA device, turn TF32 off for matmuls and cuDNN;
2. build: compile the hand-written kernels (isph_tpu_torch/csrc/*.cu) for
   sm_90a and print the build time and the compiler's register report;
3. kernels: on the pressure-Poisson matrix of the 256^2 Taylor-Green lattice
   (65,536 particles, K = 32, ~1.79M nonzeros), hold the ELL SpMV kernel
   (C = 1, 2, 3 in f32 and f64, and on two ragged K = 33 ELLs, N = 65,573
   and N = 65,533: the one-row path) against its plain version on the
   same slot format (rtol 1e-5 f32, 1e-12 f64, relative to the row's
   terms) and the take kernel (f32, f64, int32, uint8 and bool at (N,),
   (2, N) and (3, N), three fields that start one element into a larger
   buffer, and a ragged K = 33 by m = 65,573 gather of every type) against
   take_plain exactly, and both against one library call (a CSR product,
   index_select); time each with CUDA events beside its bound, the least
   time the card's HBM rate allows for the bytes of its format, and log
   the bytes the SpMV streams;
4. main path: three 256^2 Taylor-Green projection steps in f32 with
   Jacobi through Simulation.run, one step per call so that each step is
   timed (the same steps as run(state, 3)), with the launch counters reset
   just before and read just after; checks overflow, finiteness, volume,
   the decaying vmax, and that both kernels ran;
5. golden: the reference's TGV-16 table in f32 through the kernels, within
   2% (the bar tests/test_f32.py holds the JAX package to);
6. band kernels: on the pressure-Poisson matrix of the 1024^2 Taylor-Green
   lattice (1,048,576 particles, K = 32, stream window 3072, subcap 64,
   ~27M nonzeros), the same for the band SpMV on its 16-bit window offsets
   (C = 1, 2, 3 in f32 and f64, and an x one element into a larger buffer),
   the non-band SpMV, and take (every type and shape of phase 3 but the
   ragged one, and an index array one element into a larger buffer),
   timed beside the non-band kernels, warm and with L2 flushed; log the
   take_band plan, its window re-read and the bytes each SpMV streams;
   show that a window of 128 with subcap 1 overflows;
7. large-N path: three 1024^2 f32 steps through Simulation.run with the
   default AMG preconditioner (max age 8) on the streaming neighbor list;
   checks overflow, the Poisson iteration cap, volume, the decaying vmax,
   and that both band kernels ran; prints the peak device memory and one
   synchronized breakdown with the AMG build and the V-cycles apart;
8. 3-D kernels: on the pressure-Poisson matrices of the Quintic (cut = 3h,
   K = 392) 3-D Taylor-Green lattices at 64^3 (262,144 particles, ~102M
   nonzeros) and 24^3 (the reference's per-rank scaling size), the SpMV
   (C = 1 and 3 in f32 and f64) and take (f32 (N,) and (3, N), int32 and
   bool) against their plain versions as in phase 3, timed beside their
   bounds, plain versions and library calls (scripts/spmv_variants.py times
   the SpMV's two paths forced at these shapes: the measurement behind the
   path rule of csrc/spmv_vec.cuh);
9. 3-D path: three TGV-64^3 f32 Quintic steps through Simulation.run with
   the default AMG; checks overflow, the 388 neighbors a particle, the
   Poisson iteration cap, finiteness, volume, the decaying vmax and that
   both kernels ran; prints the neighbor build's own peak, the step's peak
   device memory, one synchronized breakdown and the Poisson iterations of
   one more step with Jacobi beside AMG's;
10. channel kernels: on the matrices of the ny = 1024 Poiseuille channel
   (424,064 particles padded, K = 48: the one-row SpMV path), the SpMV
   against its plain version as in phase 3 on the pressure-Poisson matrix
   with its solid and homogeneous-Neumann wall rows (C = 1 and 2 in f32 and
   f64), its fluid block (f32 C = 1) and the MorrisHolmes Helmholtz matrix
   (f32 C = 1 and 2), and take (f32 (N,) and (2, N), int32 and bool) on the
   neighbor list, timed beside their bounds, plain versions and library
   calls;
11. channel: three steps of that channel (MorrisHolmes walls, shift 0.07)
   in f32 with the default AMG; checks overflow, that the walls neither
   move nor gain velocity, finiteness, the velocity error against the
   transient profile (5%, tests/test_channel.py's bar), and that both
   kernels ran; prints one synchronized breakdown with the shift apart;
12. electrokinetic kernels: on the Poisson-Boltzmann Jacobian of the
   electroosmotic channel of phase 14 (K = 48, N = 268,288), the SpMV in
   f64 C = 1 and take in f64 and int32 (N,) against their plain versions
   as in phase 3, timed beside their bounds, plain versions and library
   calls;
13. electrokinetic goldens, f64: the PB harmonic manufactured solution at
   N = 16 and 32 within 1e-6 of tests/test_electrokinetics.py's goldens;
   the channel-EDL potential (nonlinear PB, kappa = 10, MorrisHolmes
   mirror) at n = 32 within 5% of the reference's table and at n = 256
   (13,936 particles) below the JAX package's own error at n = 128, with
   its Newton iterations, NormF and solve time; at n = 512 (53,448
   particles) the reference's Newton does not converge (JAX's stops at
   its cap of 100 too), and the script logs the same numbers; applied-efield-potential-2d
   at n = 64: its error against the Henry field within 1e-6 relative of
   the JAX package's (henry-efield-2d, whose GMRES stalls in both
   packages, is logged only);
14. electroosmotic channel: three f64 steps of channel-edl-linear-2d at
   n = 512 (268,288 particles, linearized PB, eps = 0.02, default AMG)
   through Simulation.run; checks overflow, finiteness, fixed walls, the
   flow in -x and that both kernels ran; one synchronized breakdown of
   the first step with the PB Newton solve (held to NormF <= 1e-8), the
   force, Helmholtz and the Poisson V-cycles apart; the idle share of the
   first step, profiled (torch.profiler, kernel events); then one f32 step
   of the same deck,
   whose Newton runs to its cap (the absolute stopping test lies below f32
   round-off);
15. transport: five f64 steps of square-concentration-fix-2d at n = 1024
   (1,048,576 particles, d0 = 0.02) through Simulation.run, held to
   tests/test_decks.py's bars (L2 error against the heat kernel < 0.06,
   mass within 0.02 of 0.16);
16. walls and entry points: (g) the generic analytic-error fix
   (models/error.py, the TGV deck's Function List strings) on phase 4's
   state against tgv.compute_error within 1e-5; (a) the block Helmholtz on
   that wall-free state against the per-component solve within 1e-5, with
   one take launch in its matvec; (b) three steps of the ny = 1024 channel
   with Navier-slip friction beta = 0.01 and the coupled block Helmholtz
   (MorrisHolmes mirrors, shift 0.07) through Simulation.run_adaptive
   (cfl 0.25, dx = 1/1024): no overflow, the block GMRES converged each
   step, finite fields, fixed walls, mean fluid vx > 0, both kernels ran;
   logs the dt sequence, each step's iterations and time, the launches,
   the peak memory and a synchronized breakdown with the block Helmholtz
   apart; (d) a checkpoint after step 2 restored into the step-1 state
   bit for bit (AMG cache included), one more step from both within 1e-6
   (bit-equality logged); (e) one dump frame through io/dump.py and the
   native writer, read back equal, both times logged; (f) the wall
   traction finite, the lower wall's drag along the flow, the largest
   fluid |div v|, a finite curl, smooth_field of a constant within 1e-6;
   (c) one step with the scalar Navier-slip rows at beta = 5 and 0:
   friction lowers the kinetic energy;
17. pore-scale kernels (run after phase 18, on its step-1 state): take on
   the phase ids (int32 (N,)), the Shepard volumes (f64 (N,)) and the wall
   normals (f64 (3, N)) over the neighbor list, and the SpMV in f64 C = 1
   on the Poisson fluid block (N = 703,040, K = 88), against their plain
   versions as in phase 3, timed beside their bounds, plain versions and
   library calls;
18. the flagship deck, multiphase-pore-scale-flow-b-3d at its own N = 96
   (703,040 particles, K = 88, Quintic, f64: CSF surface tension with a
   10-degree contact angle, phase injection and its ignore band,
   MorrisHolmes walls on the carved cylinder and beads, shift 0.07,
   default AMG).  As the deck stands, with the reference's antisymmetric
   momentum-preserving pressure gradient, it diverges within three steps
   in its SI parameters and in tests/test_decks.py's gentler regime (g 1,
   rho 1, nu 2e-4, alpha 1e-4) alike, as the JAX package's does (on the
   CPU at n = 32 at step 4): both are logged up to the divergence, a
   record.  Then three steps in the SI parameters with the symmetric
   corrected gradient (the JAX package's colloid-in-channel deck makes the
   same change for the same growth) through Simulation.run; checks
   overflow, finiteness, the Poisson cap, that walls and beads stay
   put, that the injected phase grows from 0, that the CSF force and
   curvature vanish in the ignore band where the color gradient does not,
   and that csf_force on the card equals the same function on a CPU copy
   of the step-1 state and geometry within 1e-12; one synchronized
   breakdown with the surface tension apart, the idle share of a profiled
   step, the peak memory;
19. the other new paths: three f64 steps of square-droplet-2d at n = 256
   (262,144 particles, K = 80, pairwise Tartakovsky-Meakin; the drop's
   anisotropy stays within 1.5x its start); isph-micelle at its deck size
   (bonds through extra_force: at the rest length nothing moves, at
   0.8 dx the fluid does, and two runs agree bit for bit); the random
   stress for one step on phase 4's state (the tensor symmetric and
   traceless, the force linear in sqrt(kBT), the noise a function of
   (seed, step) alone);
20. the MLS/ALE golden: flow-past-cylinder-2d-mls at n = 32, f64, 20
   steps through Simulation.run, held to tests/test_decks.py's bars
   (finite fields, Poisson relres < 1e-6, no overflow, Cd within 2% of
   1.8561873826547262, |Cl| < 5% of Cd); both kernels ran;
21. the cylinder at size: n = 256 (65,536 particles, the cylinder 51 dx
   across, K = 48, f64), three steps through Simulation.run, each Poisson
   relres < 1e-6 and vmax within 1e-5 relative of the JAX package's (its
   Jacobi GMRES(50) stops at the 750-iteration cap in both packages); the
   median step, iterations, peak memory, a breakdown by the step's named
   phases (utils/profiling.named_scope bracketed by synchronizes) and the
   idle share of a profiled step; then one step at n = 512 (262,144
   particles), its iterations and relres logged;
22. MLS kernels (run after phase 23): ell_spmv in f64 C = 1 on phase 21's
   ALE Poisson matrix (N = 65,536, K = 48) and on the 3-D MLS Laplacian of
   poisson-operator-3d at n = 64 (N = 262,144, K = 360, 94.4M slots), take
   on the cylinder's f64 pressure and int32 kinds, against their plain
   versions as in phase 3, timed beside their bounds, plain versions and
   library calls;
23. the MLS operator decks: tests/test_decks.py's residual-order bars
   (the residual of the MLS Laplacian rows on p = sum cos(2 x_d) shrinks
   by a factor below 0.6 and ends under 0.08 * 8; 0.1 * 8 on the boundary
   deck) for poisson-operator-2d at n = 256 and 512, poisson-operator-3d at
   32 and 64 (with each assembly's peak memory) and poisson-boundary-2d at
   56 and 112;
24. the solver extras on the main path (TGV-256^2, f32, K = 32): (a)
   three steps with precond "ilu" (ILU(0) GMRES on the Helmholtz solves,
   the singular Poisson on its Jacobi fallback), their iterations beside
   phase 4's (at 256^2, where dt nu/dx^2 ~ 6, ILU(0) GMRES stalls short of
   the tolerance); the ILU build time on the step-1 Helmholtz matrix; the
   step-1 ILU solve on the card against the port on the CPU on the same
   f32 matrix (factors within 1e-6, iterations equal, relres within 5e-3
   relative, x within 3e-5 of max |x|); the factorization's take through
   the flat (K, N) index of every slot exact against take_plain, and its
   L and U sweep SpMVs (zero diagonal, f32 C = 1 and 2) against their
   plain versions as in phase 3, with bounds, plain and library times; (b)
   three steps with recycle_k = 8, p within 1e-4 of max |p| of phase 4's;
   (c) three steps of pipelined CG beside three of CG, both Jacobi, p
   within 3e-4; (d) GMRES with chebyshev(degree=3) on the step-1 Helmholtz
   matrix beside Jacobi, which must converge;
25. ReaxFF QEq at the size users run: 262,144 atoms on a jittered 64^3
   lattice at 2.17 A (0.098 atoms/A^3, the reference's PETN crystal), f64,
   two types, K = 448, cutoff 10 A and tol 1e-6 (LAMMPS's documented
   fix qeq/reax 1 0.0 10.0 1.0e-6); six solve_qeq calls on fixed
   positions, each converged and neutral, the sixth in no more iterations
   than the first, with the neighbor build's and the solves' peaks, the
   launches and the idle share of a profiled call; the SpMV on H (f64
   C = 2) and take on the type ids (int32) and positions (f64 (3, N))
   against their plain versions as in phase 3; the 4,096-atom lattice solved to 1e-10 on the card, its
   charges within 1e-10 of the port's on the CPU and of the JAX package's
   (QEQ_JAX, scripts/qeq_jax_reference.py);
26. the sharded step (parallel/sharded.py) at world size 1 on NCCL, in this
   process (a file:// store in a temporary directory; no fallback): (a)
   three TGV-1024^2 f32 AMG steps, phase 7's lattice, n_loc from
   choose_n_loc and the halo sized to the cut layer of the slab faces (+25%,
   logged), the AMG cache on as phase 7's driver caches: KE and vmax within
   1e-4 relative of phase 7's, nfluid exact, no overflow, both kernels
   ran; the median step, sharded_overhead_ratio_1m (over phase 7's median),
   the iterations beside phase 7's, the V-cycles of one more step, the idle
   share of a profiled step, the peak memory; (d) the kernels of the
   overlapped matvec at (a)'s shapes: the SpMV of A_own (the slab's Poisson
   matrix, halo-column values zeroed; f32 and f64 C = 1) and the (K, 2H)
   boundary-strip take (f32, f64 at (N,) and (2, N)) against their plain
   versions as in phase 3; (b) TGV-256^2 f64 h_factor 1.6 Jacobi from a
   common first step (its Poisson right-hand side is round-off), three
   sharded steps against the one-device steps: iterations equal, fields
   within 1e-9 after matching by position; (c) bench.py's
   bench_sharded_overhead cell (TGV-128^2 f32 Jacobi, K = 32, halo 640):
   sharded_overhead_ratio, both steps timed with CUDA events.

The last lines are the card's name and power limit from nvidia-smi, one
JSON line describing the kernels (time, launches on the main path, plain
and library times and bound of each, at the f32 (N,) shape of its phase;
ell_spmv and take also at 64^3, on the channel, on the PB Jacobian, on
the pore-scale deck, on the MLS matrices and fields of phase 22, on the
ILU factors and gathers of phase 24, the QEq matrix, types and
positions of phase 25 and the sharded A_own and strip of phase 26, with
their launches on phases 9, 11, 14-16, 18, 19, 21, 24, 25 and 26),
and the result line
{"ok": true, "device": {...}}.  Without a CUDA device it prints no result
and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def _log(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int = 30, flush: torch.Tensor | None = None):
    """(median device ms, host us) of one call.  CUDA events bracket each
    call; a sleep kernel holds the stream first, so the host queues every
    call before the device runs any and the events time the device alone,
    not the Python wrapper.  Host us is the enqueue cost of one call.  With
    ``flush`` the 50 MB L2 is overwritten before every call (cold caller)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clocks
    marks = []
    t0 = time.perf_counter()
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        marks.append((s, e))
    host_us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks), host_us


def _tgv(dev, n_lat, precond, **neighbor):
    """TGV-n_lat f32, K = 32, padded to 128, tight lattice cell capacity;
    ``neighbor`` overrides NeighborConfig fields (the stream window)."""
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.ops.neighbors import lattice_cell_capacity

    sim0, _ = tgv.make_tgv(n_lat, dtype=torch.float32, device=dev)
    cap = lattice_cell_capacity(sim0.domain, sim0.cfg.cut, 2 * math.pi / n_lat)
    sim, state = tgv.make_tgv(n_lat, dtype=torch.float32, max_neighbors=32,
                              pad_multiple=128, cell_capacity=cap, device=dev)
    cfg = sim.cfg.replace(
        solver=dataclasses.replace(sim.cfg.solver, precond=precond),
        neighbor=dataclasses.replace(sim.cfg.neighbor, **neighbor))
    return dataclasses.replace(sim, cfg=cfg), state


def _tgv256(dev):
    return _tgv(dev, 256, "jacobi")


def _tgv1024(dev):
    """bench.py:bench_spmv_streaming's lattice and window, AMG (the default)."""
    return _tgv(dev, 1024, "amg", stream_window=3072, stream_subcap=64)


def _geometry(sim, state):
    """(neighbor list, pair geometry, computePre) of a state; fails on a
    neighbor overflow."""
    nbrs = sim.neighbors(state)
    if int(nbrs.overflow) != 0:
        raise RuntimeError(f"neighbor overflow {int(nbrs.overflow)}")
    geom = sim.geometry(state, nbrs)
    return nbrs, geom, sim.precompute(state, geom)


def _poisson_matrix(sim, state):
    from isph_tpu_torch.ops import corrected as ops
    from isph_tpu_torch.state import Kind

    _, geom, pre = _geometry(sim, state)
    return ops.laplacian_matrix(
        geom, pre.vfrac, pre.Gc, pre.Lc, state.kind, alpha=-sim.cfg.dt,
        material=1.0 / state.rho, filt=ops.PairFilter(Kind.FLUID, Kind.FLUID),
        family=ops.SYMMETRIC)


def _spmv_rel_err(yk, yp, diag, vals, idx, x):
    """max |kernel - plain| relative to the row's sum of |terms|: the two
    differ only in summation order (and FMA contraction)."""
    terms = (diag * x).abs() + (vals.abs() * x[..., idx].abs()).sum(-2)
    terms = torch.clamp_min(terms, torch.finfo(terms.dtype).tiny)  # empty padding rows
    return float(((yk - yp).abs() / terms).max()), float((yk - yp).abs().max())


HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}  # H100 SXM, no tensor cores


def _bound(nbytes: float, flops: float = 0.0, dtype=torch.float32):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the HBM rate and the operations over the peak rate."""
    tb = 1e3 * nbytes / HBM_BYTES_PER_S
    tf = 1e3 * flops / FLOPS_PER_S[dtype]
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _spmv_bound(nnz, n, ncomp, dtype, col_bytes=4, slot_ends=True):
    """An SpMV reads each nonzero's value and column once (the diagonal
    apart; ``col_bytes`` the width of the format's column code: 4 for the
    int32 index, 2 for band offsets), diag, x and (``slot_ends``) the 2-byte
    slot ends once, and writes y once; 2 flops a nonzero.  Without slot ends
    and with 4-byte columns it is the first kernels' bound."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = ((nnz - n) * (item + col_bytes) + n * item + 2 * ncomp * n * item
              + (2 * n if slot_ends else 0))
    return _bound(nbytes, 2.0 * ncomp * nnz, dtype), nbytes


def _spmv_tiles():
    """(V by value size, kMinVecThreads) of the SpMV kernels, read from
    csrc/spmv_vec.cuh."""
    from isph_tpu_torch import _build

    hdr = (_build.CSRC / "spmv_vec.cuh").read_text()
    size = {"float": 4, "double": 8}
    vec = {size[t]: int(v) for t, v in re.findall(
        r"struct Tile<(\w+)> \{\s*static constexpr int V = (\d+),", hdr)}
    mult, shift = re.search(r"constexpr int64_t kMinVecThreads = (\d+) << (\d+);", hdr).groups()
    return vec, int(mult) << int(shift)


def _spmv_rows_per_thread(n, item, aligned=True):
    """Rows a thread of the SpMV kernels covers (spmv_vec.cuh:use_vec): V,
    or 1 on the one-row path (a small N, an N that V does not divide, an
    unaligned pointer)."""
    vec, min_vec = _spmv_tiles()
    v = vec[item]
    return v if aligned and n % v == 0 and n // v >= min_vec else 1


def _spmv_streamed(slot_end, K, n, ncomp, item, col_bytes, vec):
    """Bytes an SpMV kernel moves: on the V-row path (``vec`` > 1) each warp
    (32 * vec rows) streams values and column codes up to its rows' largest
    slot end and reads the slot ends, on the one-row path every thread all
    K slots; then diag, x and y once."""
    if vec == 1:
        return K * n * (item + col_bytes) + n * item + 2 * ncomp * n * item
    se = slot_end.to(torch.int64)
    rows = 32 * vec
    se = torch.nn.functional.pad(se, (0, -n % rows)).view(-1, rows).amax(1)
    slots = min(int(se.sum()) * rows, K * n)
    return slots * (item + col_bytes) + n * (item + 2) + 2 * ncomp * n * item


def _csr_of(diag, vals, idx, mask):
    """The ELL matrix, diagonal folded in, as a CSR tensor with int32
    indices: the library SpMV's operand, built outside the timed windows."""
    K, n = vals.shape
    ar = torch.arange(n, device=vals.device)
    keep = mask.reshape(-1) != 0
    rows = torch.cat([ar.repeat(K)[keep], ar])
    cols = torch.cat([idx.reshape(-1).long()[keep], ar])
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                  torch.cat([vals.reshape(-1)[keep], diag]), (n, n))
    csr = coo.coalesce().to_sparse_csr()
    return torch.sparse_csr_tensor(csr.crow_indices().int(), csr.col_indices().int(),
                                   csr.values(), (n, n))


def _library_spmv(csr, x):
    return csr @ x if x.ndim == 1 else (csr @ x.T).T


def _library_take(x, idx):
    """One PyTorch call computing take: index_select over the flat index."""
    return torch.index_select(x, -1, idx.reshape(-1)).reshape(*x.shape[:-1], *idx.shape)


TAKE_TYPES = (("f32", torch.float32), ("f64", torch.float64), ("int32", torch.int32),
              ("uint8", torch.uint8), ("bool", torch.bool))
# the fields the main path gathers (positions and velocities (2, N), scalar
# f32 fields, kind bitmasks) and the bool rows of earlier PRs
TAKE_MAIN_SHAPES = ("f32 (N,)", "f32 (2,N)", "int32 (N,)", "bool (N,)")


def _field(rng, shape, dtype, dev, offset=False):
    """Seeded field; with ``offset`` a view starting one element into a
    larger buffer (its base breaks every vector alignment)."""
    size = math.prod(shape) + int(offset)
    if dtype == torch.bool:
        a = rng.random(size) < 0.5
    elif dtype in (torch.int32, torch.uint8):
        a = rng.integers(0, 256 if dtype == torch.uint8 else 2**31 - 1, size)
    else:
        a = rng.standard_normal(size)
    t = torch.as_tensor(a, device=dev).to(dtype)
    return (t[1:] if offset else t).view(shape)


def _take_fields(rng, n, dev):
    """Every type at (N,), (2, N) and (3, N), and three offset views."""
    fields = {}
    for tname, dtype in TAKE_TYPES:
        for c in (1, 2, 3):
            shape = (n,) if c == 1 else (c, n)
            fields[f"{tname} ({'N,' if c == 1 else f'{c},N'})"] = _field(rng, shape, dtype, dev)
    for tname, dtype, shape in (("f32", torch.float32, (3, n)), ("f64", torch.float64, (n,)),
                                ("bool", torch.bool, (2, n))):
        fields[f"{tname} {tuple(shape)} offset 1"] = _field(rng, shape, dtype, dev, offset=True)
    return fields


def _take_bytes(x, idx, x_read=None):
    """idx and x read once, the (C, K, m) output written once; with
    ``x_read`` only that many of x's columns are read (a gather that touches
    a part of x: the distinct columns of idx)."""
    ncomp = 1 if x.ndim == 1 else x.shape[0]
    cols = x.shape[-1] if x_read is None else x_read
    return idx.numel() * 4 + ncomp * (cols + idx.numel()) * x.element_size()


def _take_sweep(tag, kernel, idx, fields, flush, beside=None, main_shapes=TAKE_MAIN_SHAPES,
                x_read=None):
    """Hold ``kernel(x, idx)`` against take_plain, atol 0, on every field,
    and the library call too; time the kernel and the library call at each
    field, and for ``main_shapes`` also the plain version, the kernel with
    L2 flushed and ``beside`` (the non-band kernel).  ``x_read`` is
    _take_bytes's; where it is given the bound counts only those columns,
    and a share above 1 (a bound the kernel beat) fails."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    rows = {}
    for name, f in fields.items():
        gk = kernel(f, idx)
        gp = sc.take_plain(f, idx)
        gl = _library_take(f, idx)
        torch.cuda.synchronize()
        if gk.dtype != f.dtype or gk.shape != gp.shape or not torch.equal(gk, gp):
            raise RuntimeError(f"{tag} kernel disagrees with plain ({name})")
        if not torch.equal(gl, gp):
            raise RuntimeError(f"{tag} library call disagrees with plain ({name})")
        tk, hk = _median_ms(lambda: kernel(f, idx))
        tl, _ = _median_ms(lambda: _library_take(f, idx), reps=10)
        nbytes = _take_bytes(f, idx, x_read)
        bound, by = _bound(nbytes)
        row = dict(ms=tk, library_ms=tl, bound_ms=bound, bound_by=by, plain_ms=None)
        more = ""
        if name in main_shapes:
            row["plain_ms"], _ = _median_ms(lambda: sc.take_plain(f, idx), reps=10)
            tkc, _ = _median_ms(lambda: kernel(f, idx), flush=flush)
            more = f", L2 flushed {tkc:.4f} ms, plain={row['plain_ms']:.4f} ms"
            if beside is not None:
                row["beside_ms"], _ = _median_ms(lambda: beside(f, idx))
                more += (f", non-band take={row['beside_ms']:.4f} ms (the same function on "
                         f"the same inputs: its plain and library times are this row's)")
        rows[name] = row
        _log(f"{tag}: {name}: exact; kernel={tk:.4f} ms, bound={bound:.4f} ms "
             f"({nbytes / 1e6:.3f} MB), share={bound / tk:.3f}, library={tl:.4f} ms"
             f"{more}; host enqueue {hk:.1f} us")
        if x_read is not None and bound > tk:
            raise RuntimeError(f"{tag} ({name}): {tk:.4f} ms beats its bound {bound:.4f} ms")
    return rows


def _spmv_sweep(tag, kernel, plain, A, nnz, flush, rng, shapes, beside=None,
                x_offset=False):
    """Hold ``kernel(diag, vals, x)`` against ``plain(diag, vals, x)``, the
    plain version on the kernel's own inputs (A.slots), and against the
    library CSR product on every (dtype, C) of ``shapes``; check that the
    plain version equals spmv_plain; time all three (and ``beside(diag,
    vals, x)``, another kernel on the same matrix, where given), warm and
    with L2 flushed.  With ``x_offset`` x starts one element into a larger
    buffer (the one-row path)."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    # bound: y_k - y_p is a difference of two summation orders (and FMA
    # contraction) of the row's terms, so it is held relative to the sum of
    # the terms' magnitudes: f32 rtol 1e-5 (~K eps), f64 rtol 1e-12; the
    # library product is held to the same bound
    K, n = A.vals.shape
    col_bytes = 4 if A.slots.off is None else 2
    err = 0.0
    rows = {}
    for dtype, comps in shapes:
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        item = torch.empty((), dtype=dtype).element_size()
        diag, vals = A.diag.to(dtype), A.vals.to(dtype)
        csr = _csr_of(diag, vals, A.idx, A.mask)
        for ncomp in comps:
            shape = (n,) if ncomp == 1 else (ncomp, n)
            x = _field(rng, shape, dtype, A.vals.device, offset=x_offset)
            yk = kernel(diag, vals, x)
            yp = plain(diag, vals, x)
            yl = _library_spmv(csr, x)
            torch.cuda.synchronize()
            if not torch.equal(yp, sc.spmv_plain(diag, vals, A.idx, x)):
                raise RuntimeError(f"{tag} plain version differs from spmv_plain "
                                   f"({dtype}, C={ncomp})")
            rel, abs_err = _spmv_rel_err(yk, yp, diag, vals, A.idx, x)
            rel_l, _ = _spmv_rel_err(yl, yp, diag, vals, A.idx, x)
            err = max(err, abs_err)
            if not (rel <= rtol and bool(torch.isfinite(yk).all())):
                raise RuntimeError(f"{tag} disagrees with plain ({dtype}, C={ncomp}): "
                                   f"rel {rel:.3e}")
            if not rel_l <= rtol:
                raise RuntimeError(f"{tag} library CSR product disagrees with plain "
                                   f"({dtype}, C={ncomp}): rel {rel_l:.3e}")
            tk, hk = _median_ms(lambda: kernel(diag, vals, x))
            tkc, _ = _median_ms(lambda: kernel(diag, vals, x), flush=flush)
            tp, _ = _median_ms(lambda: plain(diag, vals, x), reps=10)
            tl, _ = _median_ms(lambda: _library_spmv(csr, x), reps=10)
            (bound, by), nbytes = _spmv_bound(nnz, n, ncomp, dtype, col_bytes)
            (bound32, _), nbytes32 = _spmv_bound(nnz, n, ncomp, dtype, slot_ends=False)
            vec = _spmv_rows_per_thread(n, item, aligned=not x_offset)
            streamed = _spmv_streamed(A.slots.slot_end, K, n, ncomp, item, col_bytes, vec)
            more = ""
            if beside is not None:
                te, _ = _median_ms(lambda: beside(diag, vals, x))
                more = f", beside {te:.4f} ms"
            rows[(dtype, ncomp)] = dict(ms=tk, plain_ms=tp, library_ms=tl, bound_ms=bound,
                                        bound_by=by)
            _log(f"{tag}: {str(dtype)[6:]} C={ncomp}: max_abs_err={abs_err:.3e} "
                 f"rel_to_terms={rel:.3e} (rtol {rtol:.0e}); kernel={tk:.4f} ms "
                 f"(L2 flushed {tkc:.4f}), bound={bound:.4f} ms ({nbytes / 1e6:.1f} MB {by}, "
                 f"{col_bytes}-byte columns and slot ends; first kernels' bound "
                 f"{bound32:.4f} ms, {nbytes32 / 1e6:.1f} MB), "
                 f"share={bound / tk:.3f} (of the first kernels' bound {bound32 / tk:.3f}), "
                 f"streamed {streamed / 1e6:.1f} MB (V={vec}), "
                 f"plain={tp:.4f} ms, library CSR={tl:.4f} ms{more}; "
                 f"{ncomp * nnz / tk / 1e6:.2f} Gnnz/s; host enqueue {hk:.1f} us")
        del csr
    return rows, err


def _ell_paths(A):
    """(kernel, plain) of ell_spmv on A's pattern and slot ends, taking
    (diag, vals, x)."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    idx, slots = A.idx, A.slots

    def kernel(d, v, x):
        return sc.ell_spmv(d, v, idx, x, slots)

    def plain(d, v, x):
        return sc.spmv_slots_plain(d, v, idx, slots.slot_end, x)

    return kernel, plain


def _unbanded(A):
    """A matrix of a streaming list as a plain ELL (its slot format without
    band offsets), for the non-band kernel."""
    from isph_tpu_torch.ops.ell import ELL

    return A if A.band is None else ELL(diag=A.diag, vals=A.vals, idx=A.idx, mask=A.mask)


def _sweep_ell(tag, A, nnz, flush, rng, shapes, **kw):
    """_spmv_sweep of ell_spmv on A."""
    A = _unbanded(A)
    return _spmv_sweep(tag, *_ell_paths(A), A, nnz, flush, rng, shapes, **kw)


def _ragged_ell(A, K, m):
    """A synthetic ELL of K slots over m rows, repeating A's slots, rows and
    columns (taken mod m, so it keeps the lattice's locality)."""
    from isph_tpu_torch.ops.ell import ELL

    dev = A.vals.device
    ks = torch.arange(K, device=dev) % A.vals.shape[0]
    rows = torch.arange(m, device=dev) % A.n
    return ELL(diag=A.diag[rows].contiguous(), vals=A.vals[ks][:, rows].contiguous(),
               idx=(A.idx[ks][:, rows] % m).contiguous(), mask=A.mask[ks][:, rows].contiguous())


def phase_kernels(dev, flush):
    """Kernels against their plain versions on the TGV-256 Poisson matrix."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _tgv256(dev)
    A = _poisson_matrix(sim, state)
    K, n = A.vals.shape
    nnz = int(A.mask.sum().item()) + n
    _log(f"kernels: TGV-256 Poisson matrix N={n} K={K} nnz={nnz}")
    rng = np.random.default_rng(0)
    both = ((torch.float32, (1, 2, 3)), (torch.float64, (1, 2, 3)))
    spmv, spmv_err = _sweep_ell("kernels: spmv", A, nnz, flush, rng, both)
    # ragged synthetic ELLs, the scalar (V = 1) path, at N on both sides of
    # 65,536
    for m in (65536 + 37, 65536 - 3):
        R = _ragged_ell(A, 33, m)
        _, err_r = _sweep_ell(f"kernels: spmv K=33 N={m}", R, int(R.mask.sum().item()) + m,
                              flush, rng, ((torch.float32, (1, 3)), (torch.float64, (1, 3))))
        spmv_err = max(spmv_err, err_r)
    take = _take_sweep("kernels: take", sc.take, A.idx, _take_fields(rng, n, dev), flush)

    # a ragged rectangular gather into an x of another width: K = 33 slots
    # over m = 65,536 + 37 rows, the matrix's columns repeated (a halo strip
    # keeps the neighbor list's locality)
    idx_r = A.idx[torch.arange(33, device=dev) % K][:, torch.arange(65536 + 37, device=dev) % n]
    ragged = {f"{t} ({'N,' if c == 1 else f'{c},N'}) ragged": _field(
        rng, (n,) if c == 1 else (c, n), dt, dev) for t, dt in TAKE_TYPES for c in (1, 3)}
    _take_sweep("kernels: take K=33 m=65573", sc.take, idx_r, ragged, flush)
    return dict(spmv_err=spmv_err, spmv=spmv[(torch.float32, 1)], take=take["f32 (N,)"])


def _run_steps(tag, sim, state, wrappers, cap_check=True, nsteps=3, each=None,
               step_times=None, step=None):
    """``nsteps`` steps through Simulation.run, one call per step
    (run(state, nsteps) in timed pieces), or through ``step(state)`` where
    given, the wrappers' launch counters set to 0 just before and read just
    after.  Fails on a neighbor overflow, a non-finite status and, with
    ``cap_check``, a Poisson solve at the iteration cap.  ``each(k, state,
    aux)`` sees every step's result; ``step_times``, a list, receives each
    step's seconds."""
    if step is None:
        step = lambda s: sim.run(s, 1)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    step_s = []
    for k in range(nsteps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        _log(f"{tag}: step {k + 1}: {step_s[-1]:.4f} s helmholtz_iters="
             f"{int(aux.helmholtz_iters)} poisson_iters={int(aux.poisson_iters)} "
             f"poisson_relres={float(aux.poisson_relres):.3e} "
             f"overflow={int(aux.neighbor_overflow)}")
        if int(aux.neighbor_overflow) != 0:
            raise RuntimeError(f"neighbor overflow on the {tag} path")
        if cap_check and int(aux.poisson_iters) >= sim.cfg.solver.max_iters:
            raise RuntimeError(f"Poisson GMRES reached the {sim.cfg.solver.max_iters} cap")
        if each is not None:
            each(k, state, aux)
    launches = {w.__name__: w.launches for w in wrappers}
    _log(f"{tag}: launches {launches}")
    if step_times is not None:
        step_times.extend(step_s)
    step_med = statistics.median(step_s[1:])
    _log(f"{tag}: step time (median of steps 2-{nsteps}) {step_med:.4f} s, "
         f"{state.n / step_med:.0f} particle-steps/s; peak memory "
         f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if not all(bool(torch.isfinite(t).all()) for t in aux.status):
        raise RuntimeError(f"non-finite status {aux.status}")
    return state, aux, launches


def _check_vortex(tag, aux, volume):
    """Volume within 1% of the box and vmax within 5% of the decaying
    vortex's 0.1 exp(-2 nu t)."""
    st = aux.status
    t = float(st.time)
    vmax_exact = 0.1 * math.exp(-2.0 * 0.1 * t)
    vol = float(st.volume)
    _log(f"{tag}: t={t:.6f} volume={vol:.6f} (exact {volume:.6f}) "
         f"vmax={float(st.vmax):.6f} (exact {vmax_exact:.6f})")
    if abs(vol / volume - 1.0) > 1e-2:
        raise RuntimeError("volume off by more than 1%")
    if abs(float(st.vmax) / vmax_exact - 1.0) > 5e-2:
        raise RuntimeError("vmax off the decaying vortex by more than 5%")


def phase_main_path(dev):
    """Three 256^2 f32 Jacobi projection steps through Simulation.run."""
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _tgv256(dev)
    iters = []
    state, aux, launches = _run_steps("main", sim, state, (sc.ell_spmv, sc.take),
                                      cap_check=False, each=_record_iters(iters))
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")
    _check_vortex("main", aux, (2 * math.pi) ** 2)
    err = tgv.compute_error(state.replace(vstar=state.v), float(aux.status.time))
    _log(f"main: L2 error vs exact: pressure={float(err.pressure_l2):.4e} "
         f"velocity={float(err.velocity_l2):.4e}")
    _breakdown(sim, state)
    return launches, sim, state, float(aux.status.time), iters


def _record_iters(out):
    """An ``each`` for _run_steps that appends (Helmholtz, Poisson)
    iterations of every step to ``out``."""
    def each(k, state, aux):
        out.append((int(aux.helmholtz_iters), int(aux.poisson_iters)))

    return each


def _breakdown(sim, state):
    """One more step, phase by phase with a synchronize after each (host
    clock; adds the syncs' cost, so it is a breakdown, not a step time)."""
    from isph_tpu_torch.physics import ns_projection as ns

    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    mark("start")
    nbrs = sim.neighbors(state)
    mark("neighbors")
    geom = sim.geometry(state, nbrs)
    mark("geometry")
    pre = sim.precompute(state, geom)
    mark("compute_pre")
    state = state.replace(f=torch.zeros_like(state.v))
    vstar, hinfo = ns.solve_helmholtz(state, geom, pre, sim.cfg)
    mark("helmholtz")
    dp, pinfo, _, _ = ns.solve_poisson(state, geom, pre, sim.cfg, vstar)
    mark("poisson")
    dp = ns.zero_mean_pressure(dp, state)
    vstar = ns.correct_velocity(state, geom, pre, sim.cfg, vstar, dp)
    state = state.replace(vstar=vstar, dp=dp, p=ns.correct_pressure(state, sim.cfg, dp))
    ns.advance_time(state, geom, pre, sim.cfg, sim.domain)
    mark("correct+advance")
    parts = ", ".join(f"{b[0]}={1e3 * (b[1] - a[1]):.2f} ms" for a, b in zip(marks, marks[1:]))
    _log(f"breakdown: {parts}; helmholtz_iters={int(hinfo.iters.sum())} "
         f"poisson_iters={int(pinfo.iters)}")


def phase_band_kernels(dev, flush):
    """Band kernels against their plain versions (and beside the non-band
    kernels) on the TGV-1024 Poisson matrix of the streaming list."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _tgv1024(dev)
    A = _poisson_matrix(sim, state)
    band = A.band
    if band is None:
        raise RuntimeError("the TGV-1024 matrix carries no band spec")
    K, n = A.vals.shape
    nnz = int(A.mask.sum().item()) + n
    cuda = torch.device(dev).type == "cuda"
    smem, n_sm = (sc._smem_optin(0), sc._sm_count(0)) if cuda else (232448, 132)
    plan = sc.take_band_plan(n, K, 1, 4, band, smem, n_sm)
    live = int(A.slots.slot_end.to(torch.int64).sum())
    streamed = _spmv_streamed(A.slots.slot_end, K, n, 1, 4, 2, _spmv_rows_per_thread(n, 4))
    _log(f"band: TGV-1024 Poisson matrix N={n} K={K} nnz={nnz} ({live} live slots, "
         f"{K * n - live} padding); window W={band.window}, step rows S={band.rows}; "
         f"spmv_band reads x through L2 (no window staged); take_band f32 plan {plan} "
         f"(window re-read {plan.reread:.2f}x); spmv_band f32 stream {streamed / 1e6:.1f} MB "
         f"(values + 16-bit offsets to the warps' slot ends, diag, x, y) against the first "
         f"kernels' {(8 * K * n + 12 * n) / 1e6:.1f} MB (8 B on every slot)")
    rng = np.random.default_rng(1)
    slots = A.slots

    def band_kernel(d, v, x):
        return sc.ell_spmv_band(d, v, A.idx, x, band, slots)

    def band_plain(d, v, x):
        return sc.spmv_band_plain(d, v, slots.off, slots.slot_end, x, band)

    nonband, _ = _ell_paths(_unbanded(A))
    both = ((torch.float32, (1, 2, 3)), (torch.float64, (1, 2, 3)))
    spmv, err = _spmv_sweep("band: spmv", band_kernel, band_plain, A, nnz, flush, rng, both,
                            beside=nonband)
    _, err_o = _spmv_sweep("band: spmv, x offset 1", band_kernel, band_plain, A, nnz, flush,
                           rng, ((torch.float32, (1,)), (torch.float64, (1,))), x_offset=True)
    _, err32 = _sweep_ell("band: non-band spmv", A, nnz, flush, rng,
                          ((torch.float32, (1,)), (torch.float64, (1,))))
    err = max(err, err_o)
    take = _take_sweep("band: take", lambda f, i: sc.take_band(f, i, band), A.idx,
                       _take_fields(rng, n, dev), flush, beside=sc.take)
    # an index array one element into a larger buffer: the scalar path
    idx_off = torch.empty(K * n + 1, dtype=torch.int32, device=dev)[1:].view(K, n)
    idx_off.copy_(A.idx)
    _take_sweep("band: take, idx offset 1", lambda f, i: sc.take_band(f, i, band), idx_off,
                {f"{t} (N,)": _field(rng, (n,), dt, dev) for t, dt in TAKE_TYPES}, flush)

    small = dataclasses.replace(sim, cfg=sim.cfg.replace(neighbor=dataclasses.replace(
        sim.cfg.neighbor, stream_window=128, stream_subcap=1)))
    ovf = int(small.neighbors(state).overflow)
    _log(f"band: window 128, subcap 1 at TGV-1024: overflow={ovf}")
    if ovf <= 0:
        raise RuntimeError("a too-small band window reported no overflow")
    return dict(spmv_err=err, spmv32_err=err32, spmv=spmv[(torch.float32, 1)],
                take=take["f32 (N,)"])


def phase_large_n(dev):
    """Three TGV-1024^2 f32 steps through Simulation.run with AMG on the
    streaming list."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _tgv1024(dev)
    iters, step_s = [], []
    state, aux, launches = _run_steps(
        "large", sim, state, (sc.ell_spmv, sc.take, sc.ell_spmv_band, sc.take_band),
        each=_record_iters(iters), step_times=step_s)
    if min(launches["ell_spmv_band"], launches["take_band"]) <= 0:
        raise RuntimeError(f"a band kernel never launched on the large-N path: {launches}")
    _check_vortex("large", aux, (2 * math.pi) ** 2)
    _breakdown_amg("large", sim, state)
    return launches, dict(ke=float(aux.status.kinetic_energy), vmax=float(aux.status.vmax),
                          nfluid=float(aux.status.nfluid), iters=iters,
                          median_s=statistics.median(step_s[1:]))


def _breakdown_amg(tag, sim, state, forcing=None):
    """One more step, phase by phase with a synchronize after each (host
    clock), with the AMG build, the V-cycles and the shift as their own
    entries (each V-cycle bracketed by synchronizes, so GMRES's own work is
    the Poisson solve's time less the V-cycles').  ``forcing(state, geom,
    pre, mark)`` runs the scalar-field solves after the force clear, marking
    its own phases, and returns (state, a note for the log)."""
    from isph_tpu_torch.physics import block_helmholtz
    from isph_tpu_torch.physics import ns_projection as ns
    from isph_tpu_torch.physics import shift
    from isph_tpu_torch.solvers import amg

    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    cfg = sim.cfg
    mark("start")
    nbrs = sim.neighbors(state)
    mark("neighbors")
    geom = sim.geometry(state, nbrs)
    mark("geometry")
    pre = sim.precompute(state, geom)
    mark("compute_pre")
    state = state.replace(f=torch.zeros_like(state.v))
    note = ""
    if forcing is not None:
        state, note = forcing(state, geom, pre, mark)
    if cfg.ns.is_block_helmholtz_enabled:
        vstar, hinfo = block_helmholtz.solve_block_helmholtz(state, geom, pre, cfg)
        mark("block_helmholtz")
    else:
        vstar, hinfo = ns.solve_helmholtz(state, geom, pre, cfg)
        mark("helmholtz")
    A, b = ns.poisson_system(state, geom, pre, cfg, vstar)
    fluid = state.is_fluid & state.valid
    A_f = A.zero_rows(~fluid).with_diag(torch.where(fluid, A.diag, torch.ones_like(A.diag)))
    b_f = torch.where(fluid, b, 0.0)
    null = fluid.to(state.dtype)
    mark("poisson_assembly")
    cache = amg.cache_of(amg.build_amg(A_f, state.x, sim.domain, cfg.cut, null_vec=null))
    mark("amg_build")
    _log(f"{tag}: AMG coarse grids {cache.grid_shapes}, level-0 transfer "
         f"{type(cache.transfers[0]).__name__}")
    M = amg.amg_from_cache(A_f, cache, null_vec=null).apply
    vcycles = []

    def timed_M(r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = M(r)
        torch.cuda.synchronize()
        vcycles.append(time.perf_counter() - t0)
        return out

    res, _ = ns._solve(cfg, A_f, b_f, torch.zeros_like(b_f), null_vec=null, M_override=timed_M)
    mark("poisson_gmres")
    dp = ns.zero_mean_pressure(ns.relax_wall_pressure(A, b, res.x, state, pre), state)
    vstar = ns.correct_velocity(state, geom, pre, cfg, vstar, dp)
    state = state.replace(vstar=vstar, dp=dp, p=ns.correct_pressure(state, cfg, dp))
    state = ns.advance_time(state, geom, pre, cfg, sim.domain)
    mark("correct+advance")
    if cfg.shift.enabled:
        geom2 = sim.geometry(state, sim.neighbors(state))
        pre2 = sim.precompute(state, geom2)
        dr = shift.compute_shift_vectors(state, geom2, cfg)
        shift.apply_shift(state, geom2, pre2, cfg, dr, sim.domain)
        mark("shift")
    parts = {b_[0]: 1e3 * (b_[1] - a[1]) for a, b_ in zip(marks, marks[1:])}
    vc = 1e3 * sum(vcycles)
    parts["poisson_gmres"] -= vc
    parts = {**parts, "v_cycles": vc}
    total = sum(parts.values())
    _log(f"breakdown ({tag}): " + ", ".join(
        f"{k}={v:.2f} ms ({100 * v / total:.1f}%)" for k, v in parts.items())
        + f"; {len(vcycles)} V-cycles, {vc / max(len(vcycles), 1):.3f} ms each; "
        f"helmholtz_iters={int(hinfo.iters.sum())} poisson_iters={int(res.iters)}{note}")
    return int(res.iters)


def phase_golden(dev):
    """tests/test_f32.py's TGV-16 harness through the port on the card."""
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.physics import ns_projection as ns

    gp, gv, nsteps = 8.466849370245e-04, 7.500246669496e-04, 3
    sim, state = tgv.make_tgv(16, dtype=torch.float32, device=dev)
    for step in range(1, nsteps + 1):
        nbrs = sim.neighbors(state)
        geom = sim.geometry(state, nbrs)
        pre = sim.precompute(state, geom)
        state, info = ns.navier_stokes_step(state, geom, pre, sim.cfg)
        if step < nsteps:
            state = ns.advance_time(state, geom, pre, sim.cfg, sim.domain)
    err = tgv.compute_error(state, sim.cfg.dt * nsteps)
    pe = float(err.pressure_l2) / gp - 1.0
    ve = float(err.velocity_l2) / gv - 1.0
    relres = float(info.poisson.relres)
    _log(f"golden: TGV-16 f32 pressure_l2={float(err.pressure_l2):.6e} ({pe:+.4%}) "
         f"velocity_l2={float(err.velocity_l2):.6e} ({ve:+.4%}) relres={relres:.2e}")
    if abs(pe) > 2e-2 or abs(ve) > 2e-2 or not relres < 5e-5:
        raise RuntimeError("TGV-16 f32 golden off by more than 2%")


def _tgv3(dev, n_lat):
    """TGV-n_lat^3 f32 with the reference's 3-D scaling kernel (Quintic,
    cut = 3h = 4.5 dx, bench.py:391-438), K = 392 slots for its 388
    neighbors, padded to 128, default AMG."""
    from isph_tpu_torch.config import KernelType
    from isph_tpu_torch.models import tgv

    return tgv.make_tgv(n_lat, dim=3, kernel=KernelType.QUINTIC, max_neighbors=392,
                        dtype=torch.float32, pad_multiple=128, device=dev)


TAKE_3D_SHAPES = ("f32 (N,)", "f32 (3,N)", "int32 (N,)", "bool (N,)")


def phase_3d_kernels(dev, flush):
    """ell_spmv and take against their plain versions on the TGV-64^3 and
    TGV-24^3 Quintic Poisson matrices (K = 392)."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    rows, err = {}, 0.0
    for n_lat in (64, 24):
        A = _poisson_matrix(*_tgv3(dev, n_lat))
        K, n = A.vals.shape
        nnz = int(A.mask.sum().item()) + n
        live = int(A.slots.slot_end.to(torch.int64).sum())
        _log(f"3d: TGV-{n_lat}^3 Quintic Poisson matrix N={n} K={K} nnz={nnz} ({live} live "
             f"slots); f32 stream {K * n * 8 / 1e6:.1f} MB against 50 MB of L2")
        rng = np.random.default_rng(2)
        spmv, e = _sweep_ell(f"3d: spmv {n_lat}^3", A, nnz, flush, rng,
                             ((torch.float32, (1, 3)), (torch.float64, (1, 3))))
        err = max(err, e)
        fields = {k: f for k, f in _take_fields(rng, n, dev).items() if k in TAKE_3D_SHAPES}
        take = _take_sweep(f"3d: take {n_lat}^3", sc.take, A.idx, fields, flush,
                           main_shapes=TAKE_3D_SHAPES)
        rows[n_lat] = dict(spmv=spmv[(torch.float32, 1)], take=take["f32 (N,)"])
        del A, fields
        torch.cuda.empty_cache()
    return dict(spmv_err=err, rows=rows)


def phase_3d_path(dev):
    """Three TGV-64^3 f32 Quintic steps through Simulation.run with AMG."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _tgv3(dev, 64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    nbrs = sim.neighbors(state)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() - base
    cmax, ovf = int(nbrs.count.max()), int(nbrs.overflow)
    del nbrs
    _log(f"3d path: TGV-64^3 N={state.n} K={sim.cfg.neighbor.max_neighbors} cell capacity "
         f"{sim.cfg.neighbor.cell_capacity} subdiv {sim.cfg.neighbor.cell_subdiv}; neighbor "
         f"build peak {build_peak / 2**30:.2f} GiB above the state; count.max {cmax}, "
         f"overflow {ovf}")
    if cmax != 388 or ovf != 0:
        raise RuntimeError("the 3-D lattice should give 388 neighbors a particle, no overflow")
    state, aux, launches = _run_steps("3d path", sim, state, (sc.ell_spmv, sc.take))
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the 3-D path never launched: {launches}")
    _check_vortex("3d path", aux, (2 * math.pi) ** 3)
    amg_iters = _breakdown_amg("3d path", sim, state)
    jacobi = dataclasses.replace(sim, cfg=sim.cfg.replace(
        solver=dataclasses.replace(sim.cfg.solver, precond="jacobi")))
    _, aux_j = jacobi.step(state)
    _log(f"3d path: the same step's Poisson solve with Jacobi: "
         f"{int(aux_j.poisson_iters)} iterations (relres {float(aux_j.poisson_relres):.3e}) "
         f"against AMG's {amg_iters}")
    return launches


def _channel(dev):
    """The ny = 1024 Poiseuille channel, f32, shift 0.07, MorrisHolmes
    walls, default AMG, K = 48, padded to 128."""
    from isph_tpu_torch.models import channel

    return channel.make_channel(1024, shift=0.07, dtype=torch.float32, pad_multiple=128,
                                device=dev)


def _channel_matrices(sim, state):
    """The matrices a channel step applies, as the step assembles them: the
    pressure-Poisson matrix with its solid and homogeneous-Neumann wall rows
    (the wall-pressure relaxation's), its fluid block (the GMRES operator)
    and the Helmholtz matrix with the MorrisHolmes mirror; and the neighbor
    list's (K, N) idx."""
    from isph_tpu_torch.physics import ns_projection as ns

    nbrs, geom, pre = _geometry(sim, state)
    A, _ = ns.poisson_system(state, geom, pre, sim.cfg, state.v)
    fluid = state.is_fluid & state.valid
    A_f = A.zero_rows(~fluid).with_diag(torch.where(fluid, A.diag, torch.ones_like(A.diag)))
    A_h, _ = ns.helmholtz_system(state.replace(f=torch.zeros_like(state.v)), geom, pre, sim.cfg)
    return dict(poisson=A, poisson_fluid=A_f, helmholtz=A_h), nbrs.idx


def phase_channel_kernels(dev, flush):
    """ell_spmv and take against their plain versions at the channel
    path's shapes (K = 48, N = 424,064: the one-row SpMV path)."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _channel(dev)
    mats, idx = _channel_matrices(sim, state)
    rng = np.random.default_rng(3)
    err, spmv = 0.0, None
    shapes = dict(poisson=((torch.float32, (1, 2)), (torch.float64, (1, 2))),
                  poisson_fluid=((torch.float32, (1,)),),
                  helmholtz=((torch.float32, (1, 2)),))
    for name, A in mats.items():
        K, n = A.vals.shape
        nnz = int(A.mask.sum().item()) + n
        _log(f"channel kernels: {name} matrix N={n} K={K} nnz={nnz} "
             f"(SpMV V={_spmv_rows_per_thread(n, 4)} in f32)")
        rows, e = _sweep_ell(f"channel kernels: spmv {name}", A, nnz, flush, rng, shapes[name])
        err = max(err, e)
        spmv = spmv or rows[(torch.float32, 1)]
    fields = {k: f for k, f in _take_fields(rng, state.n, dev).items() if k in TAKE_MAIN_SHAPES}
    take = _take_sweep("channel kernels: take", sc.take, idx, fields, flush)
    return dict(spmv_err=err, spmv=spmv, take=take["f32 (N,)"])


def phase_channel(dev):
    """Three steps of the ny = 1024 Poiseuille channel with shifting, f32."""
    from isph_tpu_torch.models import channel
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _channel(dev)
    solid = state.is_solid & state.valid
    x0 = state.x[:, solid].clone()
    _log(f"channel: N={state.n} ({int(state.valid.sum())} particles, {int(solid.sum())} "
         f"wall), walls {sim.cfg.ns.boundary.value}, shift {sim.cfg.shift.shift}, "
         f"dt {sim.cfg.dt:.6g}, precond {sim.cfg.solver.precond}")
    state, aux, launches = _run_steps("channel", sim, state, (sc.ell_spmv, sc.take))
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the channel path never launched: {launches}")
    moved = float((state.x[:, solid] - x0).abs().max())
    # the periodic wrap of every position each step may round a wall
    # particle's coordinate by an ulp of the box, no more
    ulps = 4 * torch.finfo(state.dtype).eps * float(x0.abs().max())
    wall_v = float(state.v[:, solid].abs().max())
    t = float(aux.status.time)
    err, norm = channel.velocity_error(state, t)
    rel = float(err / norm)
    _log(f"channel: t={t:.6g} wall displacement {moved:.3e} (wrap round-off bound "
         f"{ulps:.3e}), wall speed {wall_v:.3e}; velocity error {float(err):.4e} of "
         f"{float(norm):.4e} ({rel:.4%}, bar 5%)")
    if moved > ulps or wall_v != 0.0:
        raise RuntimeError("the channel walls moved or gained velocity")
    if not rel < 0.05:
        raise RuntimeError("channel velocity off the transient Poiseuille profile by 5% or more")
    _breakdown_amg("channel", sim, state)
    return launches

# the JAX package's own f64 values on the CPU (isph_tpu, the same decks),
# the bars phase 13 holds the port to on the card
EDL_POTENTIAL_REL_ERR_JAX_128 = 2.938790772664169e-03
EDL_POTENTIAL_REL_ERR_JAX_256 = 6.15884748436271e-04  # 9 Newton iterations
# at n = 512 JAX's Newton (one Jacobi GMRES(80) cycle a step) stops at its
# cap of 100 with NormF 34.95932689520356, relative error 0.99853
EDL_POTENTIAL_NORM_F_JAX_512 = 34.95932689520356
# applied-efield-potential-2d (Henry buffer potential, a solid disk of
# conductivity ratio 0.001) at n = 64; henry-efield-2d (ratio 1e-6, not
# carved) stalls at relres 0.4436 after 150 GMRES iterations in JAX
HENRY_PHI_REL_ERR_JAX_64 = 0.012896379590869126
GOLDEN_PSI = {16: 1.479161878614346e-02, 32: 3.706069041498665e-03}
GOLDEN_GRAD = {16: 4.719682089799385e-02, 32: 1.198133743842115e-02}


def _edl_flow(dev, dtype=torch.float64):
    """channel-edl-linear-2d at n = 512: 512 x 524 = 268,288 particles,
    K = 48, MorrisHolmes walls, linearized PB with eps = 0.02, default AMG."""
    from isph_tpu_torch.models import decks

    return decks.build_deck("channel-edl-linear-2d", n=512, dtype=dtype, device=dev)


def _pb_jacobian(sim, state):
    """The PB Jacobian at the state's psi, as solve_poisson_boltzmann's
    Newton assembles it, and the neighbor list's idx."""
    from isph_tpu_torch.physics import electrokinetics as ek

    nbrs, geom, pre = _geometry(sim, state)
    _, jacobian = ek.pb_system(state, geom, pre, sim.cfg)
    return jacobian(state.psi), nbrs.idx


def phase_edl_kernels(dev, flush):
    """ell_spmv (f64 C = 1) and take (f64 and int32 (N,)) against their plain
    versions on the PB Jacobian of the n = 512 electroosmotic channel."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _edl_flow(dev)
    J, idx = _pb_jacobian(sim, state)
    K, n = J.vals.shape
    nnz = int(J.mask.sum().item()) + n
    _log(f"edl kernels: PB Jacobian of channel-edl-linear-2d n=512, N={n} K={K} nnz={nnz} "
         f"(SpMV V={_spmv_rows_per_thread(n, 8)} in f64)")
    rng = np.random.default_rng(4)
    spmv, err = _sweep_ell("edl kernels: spmv", J, nnz, flush, rng, ((torch.float64, (1,)),))
    shapes = ("f64 (N,)", "int32 (N,)")
    fields = {k: f for k, f in _take_fields(rng, n, dev).items() if k in shapes}
    take = _take_sweep("edl kernels: take", sc.take, idx, fields, flush, main_shapes=shapes)
    return dict(spmv_err=err, spmv=spmv[(torch.float64, 1)], take=take["f64 (N,)"])


def _channel_edl_potential(dev, n, converge=True):
    """The channel-EDL potential deck (nonlinear PB, kappa = 10) solved with
    the MorrisHolmes mirror (safe 0): (relative psi error, Newton result,
    solve seconds, particles).  With ``converge`` a Newton that does not
    converge fails."""
    from isph_tpu_torch.models import edl
    from isph_tpu_torch.ops import corrected as ops
    from isph_tpu_torch.physics import electrokinetics as ek

    sim, state = edl.make_channel_edl(n, device=dev)
    _, geom, pre = _geometry(sim, state)
    cfg = sim.cfg
    mirror = ops.morris_holmes_mirror(geom, state.kind, pre.pnd, pre.vfrac, cfg.cut, cfg.h,
                                      safe=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psi, _, info = ek.solve_poisson_boltzmann(state, geom, pre, cfg, mirror=mirror)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    err, norm = edl.psi_error(state, psi)
    if converge and not bool(info.converged):
        raise RuntimeError(f"channel-EDL n={n}: Newton did not converge "
                           f"(NormF {float(info.norm_f):.3e})")
    return float(err / norm), info, secs, int(state.valid.sum())


def phase_edl_golden(dev):
    """The PB harmonic goldens, the channel-EDL table and the Henry field on
    the card, f64."""
    from isph_tpu_torch.config import PoissonBoltzmannConfig
    from isph_tpu_torch.models import decks, tgv
    from isph_tpu_torch.physics import electrokinetics as ek
    from isph_tpu_torch.state import Kind

    f64 = torch.float64
    for n in (16, 32):
        sim, state = tgv.make_tgv(n, device=dev)
        cfg = sim.cfg.replace(pb=PoissonBoltzmannConfig(enabled=True, ezcb=0.5, psiref=1.0,
                                                        gamma=0.0))
        state = state.replace(eps=torch.ones(state.n, dtype=f64, device=dev),
                              psi=torch.zeros(state.n, dtype=f64, device=dev),
                              psi0=torch.zeros(state.n, dtype=f64, device=dev))
        _, geom, pre = _geometry(sim, state)
        x, y = state.x[0], state.x[1]
        ex = torch.sin(x) * torch.cos(y)
        psi, grad, info = ek.solve_poisson_boltzmann(state, geom, pre, cfg,
                                                     extra_f=-2.0 * ex - torch.sinh(ex))
        w = state.valid.to(f64)
        err = float(torch.sqrt((((psi - ex) * w) ** 2).sum() / w.sum()))
        gex = torch.stack([torch.cos(x) * torch.cos(y), -torch.sin(x) * torch.sin(y)])
        gerr = float(torch.sqrt((((grad - gex) * w) ** 2).sum() / w.sum()))
        pe, ge = err / GOLDEN_PSI[n] - 1.0, gerr / GOLDEN_GRAD[n] - 1.0
        _log(f"edl golden: PB harmonic N={n}: psi L2 {err:.12e} ({pe:+.3e}), grad L2 "
             f"{gerr:.12e} ({ge:+.3e}); Newton {int(info.iters)} iterations, "
             f"{int(info.linear_iters)} GMRES, NormF {float(info.norm_f):.3e}")
        if not (bool(info.converged) and abs(pe) < 1e-6 and abs(ge) < 1e-6):
            raise RuntimeError(f"PB harmonic N={n} off its golden by 1e-6 or more")

    rel, info, secs, npart = _channel_edl_potential(dev, 32)
    _log(f"edl golden: channel-EDL n=32 ({npart} particles): relative psi error {rel:.6e} "
         f"(table 4.210116e-02, {rel / 4.210116123449621e-02 - 1.0:+.3%}); Newton "
         f"{int(info.iters)}, NormF {float(info.norm_f):.3e}")
    if not abs(rel / 4.210116123449621e-02 - 1.0) < 0.05:
        raise RuntimeError("channel-EDL n=32 off the table by 5% or more")
    for n in (256, 512):
        rel, info, secs, npart = _channel_edl_potential(dev, n, converge=n == 256)
        _log(f"edl golden: channel-EDL n={n} ({npart} particles): relative psi error "
             f"{rel:.6e} (JAX f64 at n=128: {EDL_POTENTIAL_REL_ERR_JAX_128:.6e}, at n=256: "
             f"{EDL_POTENTIAL_REL_ERR_JAX_256:.6e}); Newton {int(info.iters)} iterations, "
             f"{int(info.linear_iters)} GMRES, NormF {float(info.norm_f):.3e}; solve "
             f"{secs:.4f} s")
        if bool(info.converged) and not rel < EDL_POTENTIAL_REL_ERR_JAX_128:
            raise RuntimeError(f"channel-EDL n={n} no more accurate than JAX's n=128")
        if not bool(info.converged):
            # the reference's Newton does not converge here: JAX's stops at
            # its cap too (a record, not a failure, unless non-finite)
            _log(f"edl golden: channel-EDL n={n}: Newton at its cap, as JAX's (NormF "
                 f"{EDL_POTENTIAL_NORM_F_JAX_512:.6e} on the CPU)")
            if not math.isfinite(rel):
                raise RuntimeError(f"channel-EDL n={n}: non-finite psi")

    for deck in ("applied-efield-potential-2d", "henry-efield-2d"):
        sim, state, ex = decks.build_deck(deck, n=64, device=dev)
        _, geom, pre = _geometry(sim, state)
        phi, _ = ek.solve_applied_electric_potential(state, geom, pre, sim.cfg)
        w = (state.valid & ((state.kind & Kind.FLUID_BIT) != 0)).to(f64)
        err = float(torch.sqrt((((phi - ex) * w) ** 2).sum() / ((ex * w) ** 2).sum()))
        if deck == "henry-efield-2d":  # a record: its GMRES stalls in both packages
            _log(f"edl golden: {deck} n=64: relative phi error against the Henry field "
                 f"{err:.6e} from a stalled solve (finite: {bool(torch.isfinite(phi).all())})")
            if not bool(torch.isfinite(phi).all()):
                raise RuntimeError(f"{deck}: non-finite phi")
            continue
        off = err / HENRY_PHI_REL_ERR_JAX_64 - 1.0
        _log(f"edl golden: {deck} n=64: relative phi error against the Henry field "
             f"{err:.12e} (JAX {HENRY_PHI_REL_ERR_JAX_64:.12e}, {off:+.3e})")
        if not abs(off) < 1e-6:
            raise RuntimeError("Henry field error off JAX's by 1e-6 relative or more")


def _pb_forcing(sim, strict):
    """The breakdown's scalar-field phases: the PB Newton solve and the
    electrostatic force; with ``strict`` a Newton that did not converge to
    NormF <= tol_f fails."""
    from isph_tpu_torch.physics import electrokinetics as ek

    cfg = sim.cfg

    def forcing(state, geom, pre, mark):
        psi, psigrad, info = ek.solve_poisson_boltzmann(state, geom, pre, cfg)
        mark("pb_newton")
        state = state.replace(psi=psi, psigrad=psigrad)
        state = state.replace(f=ek.electrostatic_force(state, cfg, psigrad))
        mark("force")
        nf = float(info.norm_f)
        if strict and not (bool(info.converged) and nf <= cfg.newton.tol_f):
            raise RuntimeError(f"PB Newton did not converge: NormF {nf:.3e} after "
                               f"{int(info.iters)} iterations")
        return state, (f"; Newton {int(info.iters)} iterations, {int(info.linear_iters)} "
                       f"GMRES, NormF {nf:.3e}")

    return forcing


def _idle_share(fn):
    """Device busy and idle share of ``fn()`` (torch.profiler, CUDA kernel
    events only; one stream, so kernels do not overlap): (wall s, busy s,
    kernels).  The profiler's own host cost lengthens the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the step's named phases come back as device-side annotation ranges
    # that span their kernels: left out, as torch's own table leaves them
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
               for e in events) / 1e6
    return wall, busy, sum(e.count for e in events)


def phase_edl_path(dev):
    """Three f64 steps of the n = 512 electroosmotic channel through
    Simulation.run; a breakdown and the idle share of its first step; then
    one f32 step.  (The deck's transverse velocities grow from step to
    step in both packages; from the fourth step on the reference's Newton
    stalls at this size: PERF.md, section 6.)"""
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _edl_flow(dev)
    state0 = state
    solid = state.is_solid & state.valid
    fluid = state.is_fluid & state.valid
    x0 = state.x[:, solid].clone()
    _log(f"edl path: channel-edl-linear-2d n=512 N={state.n} ({int(fluid.sum())} fluid, "
         f"{int(solid.sum())} wall), K={sim.cfg.neighbor.max_neighbors}, walls "
         f"{sim.cfg.ns.boundary.value}, eps {float(state.eps[0]):g}, E {sim.cfg.ae.e[:2]}, "
         f"dt {sim.cfg.dt:.6g}, precond {sim.cfg.solver.precond}")
    state, aux, launches = _run_steps("edl path", sim, state, (sc.ell_spmv, sc.take))
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the electroosmotic path never launched: {launches}")
    moved = float((state.x[:, solid] - x0).abs().max())
    ulps = 4 * torch.finfo(state.dtype).eps * float(x0.abs().max())
    wall_v = float(state.v[:, solid].abs().max())
    vx = float(state.v[0][fluid].mean())
    vy = float(state.v[1][fluid].abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in (state.v, state.p, state.psi))
    _log(f"edl path: t={float(aux.status.time):.6g} mean fluid vx {vx:.6e} (expected < 0), "
         f"vmax {float(aux.status.vmax):.6e}, max |vy| {vy:.6e}, wall displacement "
         f"{moved:.3e} (bound {ulps:.3e}), wall speed {wall_v:.3e}")
    if not finite:
        raise RuntimeError("non-finite v, p or psi on the electroosmotic path")
    if moved > ulps or wall_v != 0.0:
        raise RuntimeError("the electroosmotic channel's walls moved or gained velocity")
    if not vx < 0.0:
        raise RuntimeError("the electroosmotic flow does not run in -x")
    _breakdown_amg("edl path, step 1", sim, state0, forcing=_pb_forcing(sim, strict=True))
    wall, busy, nk = _idle_share(lambda: sim.run(state0, 1))
    _log(f"edl path: step 1 profiled {wall:.4f} s, device busy {busy:.4f} s over {nk} "
         f"kernels, idle share {1.0 - busy / wall:.3f}")
    if not 0.0 < busy <= wall:
        raise RuntimeError("the profiled device time is not within the step's wall time")
    del state, state0
    torch.cuda.empty_cache()

    sim32, state32 = _edl_flow(dev, torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _breakdown_amg("edl path f32", sim32, state32, forcing=_pb_forcing(sim32, strict=False))
    _log(f"edl path f32: one step (phase by phase) {time.perf_counter() - t0:.4f} s")
    return launches


TRANSPORT_D0 = 0.02


def _transport_box(dev):
    """square-concentration-fix-2d at n = 1024: 1,048,576 particles, f64,
    K = 48, d0 = 0.02 (tests/test_decks.py's diffusivity)."""
    from isph_tpu_torch.models import decks

    return decks.build_deck("square-concentration-fix-2d", n=1024, d0=TRANSPORT_D0,
                            device=dev)


def phase_transport(dev):
    """Five f64 steps of the 1M transport box through Simulation.run, held
    to tests/test_decks.py's bars."""
    from isph_tpu_torch.models import decks
    from isph_tpu_torch.ops import spmv_cuda as sc

    d0, nsteps = TRANSPORT_D0, 5
    sim, state = _transport_box(dev)
    _log(f"transport: square-concentration-fix-2d N={state.n}, "
         f"K={sim.cfg.neighbor.max_neighbors}, d0 {d0}, dt {sim.cfg.dt:.6g}")
    state, aux, launches = _run_steps("transport", sim, state, (sc.ell_spmv, sc.take),
                                      nsteps=nsteps)
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the transport path never launched: {launches}")
    t = nsteps * sim.cfg.dt
    cex = decks.square_concentration_exact(state.x, t, d0=d0, rpatch=0.2)
    w = state.valid.to(state.dtype)
    c = state.conc[0]
    err = float(torch.sqrt((((c - cex) * w) ** 2).sum() / w.sum()))
    mass = float((c * w).sum() / w.sum())  # the unit box's integral of c
    _log(f"transport: t={t:.6g} L2 error against the heat kernel {err:.6e} (bar 0.06), "
         f"mass {mass:.12f} (0.16 +- 0.02), conc in [{float(c.min()):.3e}, "
         f"{float(c.max()):.6f}]")
    if not (bool(torch.isfinite(c).all()) and err < 0.06 and abs(mass - 0.16) < 0.02):
        raise RuntimeError("the transport box is off tests/test_decks.py's bars")
    return launches


TGV_FUNCS = {  # the TGV deck's analytic solution as the reference XML carries it
    "u.x": "u.x =  umax*exp(-2.0*nu*t)*sin(pt.x)*cos(pt.y);",
    "u.y": "u.y = -umax*exp(-2.0*nu*t)*cos(pt.x)*sin(pt.y);",
    "p": "p   =  rho*umax*umax/4.0*exp(-4.0*nu*t)*(cos(2.0*pt.x)+cos(2.0*pt.y));",
}


WALLS_UMIN = 0.2


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _walls_block_no_walls(tgv_sim, tgv_state, fail):
    """(a) The block solve on the wall-free TGV-256^2 state equals the
    per-component solve, and its matvec runs through the take kernel."""
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.physics import block_helmholtz as bh
    from isph_tpu_torch.physics import ns_projection as ns

    cfg = tgv_sim.cfg
    _, geom, pre = _geometry(tgv_sim, tgv_state)
    st = tgv_state.replace(f=torch.zeros_like(tgv_state.v))
    v_blk, info = bh.solve_block_helmholtz(st, geom, pre, cfg)
    v_sc, _ = ns.solve_helmholtz(st, geom, pre, cfg)
    rel = _rel(v_blk, v_sc)
    A, b = bh.block_helmholtz_system(st, geom, pre, cfg)
    sc.take.launches = 0
    A.matvec(b.contiguous())
    torch.cuda.synchronize()
    takes = sc.take.launches
    _log(f"walls (a): TGV-256^2 f32 (theta {cfg.ns.theta}) block solve {int(info.iters)} "
         f"iterations, relres {float(info.relres):.3e}, against the per-component solve "
         f"{rel:.3e} relative (bar 1e-5); take launches in one block matvec: {takes}")
    if not (bool(info.converged) and rel <= 1e-5 and takes == 1):
        fail("(a) the wall-free block Helmholtz is off the scalar solve, or its matvec did "
             "not run the take kernel")


def _block_f32_against_f64(sim, state):
    """max |v*_f32 - v*_f64| / max |v*_f64| of the block Helmholtz solve on
    ``state`` (f32) and on its copy cast to f64 (geometry recomputed in
    f64), and a note with both solves' iterations and relres."""
    from isph_tpu_torch.physics import block_helmholtz as bh

    out = []
    for dtype in (torch.float32, torch.float64):
        st = dataclasses.replace(state, amg_cache=None, **{
            f.name: getattr(state, f.name).to(dtype) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)
            and getattr(state, f.name).is_floating_point()})
        st = st.replace(f=torch.zeros_like(st.v))
        _, geom, pre = _geometry(sim, st)
        out.append(bh.solve_block_helmholtz(st, geom, pre, sim.cfg))
        del geom, pre
    (v32, r32), (v64, r64) = out
    note = (f"f32 {int(r32.iters)} iterations relres {float(r32.relres):.3e} converged "
            f"{bool(r32.converged)}, f64 {int(r64.iters)} iterations relres "
            f"{float(r64.relres):.3e} converged {bool(r64.converged)}")
    return _rel(v32.double(), v64), note


class _StepRecorder:
    """Records every Simulation.step call made inside the block (the dt
    each step used, its synchronized wall time, overflow, Helmholtz
    iterations and relres, and the state it returned): run_adaptive keeps
    its dt sequence and intermediate states to itself."""

    def __enter__(self):
        from isph_tpu_torch.models import driver

        self.rows, self._cls = [], driver.Simulation
        self._orig = orig = driver.Simulation.step
        rows = self.rows

        def step(sim, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(sim, state)
            torch.cuda.synchronize()
            a = out[1]
            rows.append(dict(dt=sim.cfg.dt, s=time.perf_counter() - t0,
                             overflow=int(a.neighbor_overflow), h_iters=int(a.helmholtz_iters),
                             h_relres=float(a.helmholtz_relres), p_iters=int(a.poisson_iters),
                             state=out[0]))
            return out

        driver.Simulation.step = step
        return self

    def __exit__(self, *exc):
        self._cls.step = self._orig


def _slip_channel(dev, **ns_kw):
    sim, state = _channel(dev)
    return dataclasses.replace(sim, cfg=sim.cfg.replace(
        ns=dataclasses.replace(sim.cfg.ns, **ns_kw))), state


def phase_walls(dev, tgv_sim, tgv_state, tgv_t):
    """Phase 16, walls and entry points, on the ny = 1024 channel.  Every
    check runs; the phase fails at its end naming each check that did not
    hold."""
    from isph_tpu_torch.config import BoundaryCond
    from isph_tpu_torch.io import checkpoint, dump
    from isph_tpu_torch.models import error, tgv
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.physics import diagnostics as diag

    failures = []

    def fail(msg):
        _log(f"walls: FAILED {msg}")
        failures.append(msg)

    # (g) first, on phase 4's state: the generic analytic-error fix
    fix = error.AnalyticErrorFix.from_function_list(
        TGV_FUNCS, consts={"umax": 0.1, "nu": 0.1, "rho": 1.0})
    out = fix.navier_stokes_error(tgv_state, tgv_t)
    ref = tgv.compute_error(tgv_state.replace(vstar=tgv_state.v), tgv_t)
    eu = abs(float(out["err.u.norm2"]) / float(ref.velocity_l2) - 1.0)
    ep = abs(float(out["err.p.norm2"]) / float(ref.pressure_l2) - 1.0)
    _log(f"walls (g): TGV-256^2 t={tgv_t:.6g} error fix velocity {float(out['err.u.norm2']):.6e} "
         f"({eu:.2e} off compute_error), pressure {float(out['err.p.norm2']):.6e} ({ep:.2e}); "
         "bar 1e-5")
    if not (eu <= 1e-5 and ep <= 1e-5):
        fail("(g) the analytic-error fix is off tgv.compute_error")

    _walls_block_no_walls(tgv_sim, tgv_state, fail)
    torch.cuda.empty_cache()

    # (b) the Navier-slip channel, block Helmholtz, CFL timestep
    sim, state = _slip_channel(dev, beta=0.01, is_block_helmholtz_enabled=True)
    solid = state.is_solid & state.valid
    fluid = state.is_fluid & state.valid
    x0 = state.x[:, solid].clone()
    dx = 1.0 / 1024
    tol = max(sim.cfg.solver.tol, 30 * torch.finfo(state.dtype).eps)
    _log(f"walls (b): channel N={state.n}, walls {sim.cfg.ns.boundary.value}, beta "
         f"{sim.cfg.ns.beta}, block Helmholtz, shift {sim.cfg.shift.shift}, cfg dt "
         f"{sim.cfg.dt:.6g}; run_adaptive cfl 0.25 dx {dx:.6g} umin {WALLS_UMIN}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in (sc.ell_spmv, sc.take):
        w.launches = 0
    t0 = time.perf_counter()
    with _StepRecorder() as rec:
        state3, aux, dt = sim.run_adaptive(state, 3, cfl=0.25, dx=dx, umin=WALLS_UMIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in (sc.ell_spmv, sc.take)}
    peak = torch.cuda.max_memory_allocated() / 2**20
    for k, r in enumerate(rec.rows):
        _log(f"walls (b): step {k + 1}: dt {r['dt']:.6g} (dt nu/dx^2 "
             f"{r['dt'] * 0.1 / dx**2:.1f}) {r['s']:.4f} s block GMRES {r['h_iters']} "
             f"iterations relres {r['h_relres']:.3e} (converged: {r['h_relres'] <= tol}, tol "
             f"{tol:.3e}), poisson_iters {r['p_iters']}, overflow {r['overflow']}")
    _log(f"walls (b): dt sequence {[r['dt'] for r in rec.rows]}, last {dt:.6g}; "
         f"{wall:.4f} s for 3 steps; launches {launches} "
         f"({ {k: v / 3 for k, v in launches.items()} } a step); peak memory {peak:.1f} MiB")
    moved = float((state3.x[:, solid] - x0).abs().max())
    ulps = 4 * torch.finfo(state.dtype).eps * float(x0.abs().max())
    wall_v = float(state3.v[:, solid].abs().max())
    vx = float(state3.v[0][fluid].mean())
    finite = all(bool(torch.isfinite(t).all()) for t in (state3.x, state3.v, state3.p))
    _log(f"walls (b): t={float(aux.status.time):.6g} mean fluid vx {vx:.6e}, vmax "
         f"{float(aux.status.vmax):.6e}, wall displacement {moved:.3e} (bound {ulps:.3e}), "
         f"wall speed {wall_v:.3e}")
    if len(rec.rows) != 3 or any(r["overflow"] for r in rec.rows):
        fail("(b) the Navier-slip channel overflowed its neighbor list")
    if not finite or moved > ulps or wall_v != 0.0 or not vx > 0.0:
        fail("(b) the Navier-slip channel is not finite, its walls moved or gained "
             "velocity, or the flow does not run in +x")
    if min(launches.values()) <= 0:
        fail(f"(b) a kernel of the Navier-slip path never launched: {launches}")
    state1, state2 = rec.rows[0]["state"], rec.rows[1]["state"]
    dt2, dt3 = rec.rows[1]["dt"], rec.rows[2]["dt"]
    sim3 = dataclasses.replace(sim, cfg=sim.cfg.replace(dt=dt3))
    del rec
    # the f32 block solve of step 2's system against the f64 solve of the
    # same system: f32 GMRES may stop on its stagnation exit a little above
    # 30 eps on this stiff a system, so the solution is held, not the flag
    err, note = _block_f32_against_f64(
        dataclasses.replace(sim, cfg=sim.cfg.replace(dt=dt2)), state1)
    _log(f"walls (b): step 2's block system: {note}; f32 v* against f64 {err:.3e} "
         "relative (bar 1e-4)")
    if not err <= 1e-4:
        fail("(b) the f32 block Helmholtz solution is off the f64 one")
    _breakdown_amg("walls (b), step 3", sim3, state2)

    # (d) checkpoint after step 2, restored into the step-1 state
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(path, state2)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = checkpoint.load_checkpoint(path, state1)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        size = os.path.getsize(path) / 2**20
    saved = dict(checkpoint.tensor_items("state", state2))
    back = dict(checkpoint.tensor_items("state", restored))
    exact = saved.keys() == back.keys() and all(
        saved[k].dtype == back[k].dtype and torch.equal(saved[k], back[k]) for k in saved)
    ncache = sum(k.startswith("state/amg_cache/") for k in saved)
    a, _ = sim3.run(state2, 1)
    b, _ = sim3.run(restored, 1)
    bits = all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("x", "v", "p"))
    rx, rv = _rel(b.x, a.x), _rel(b.v, a.v)
    _log(f"walls (d): checkpoint {len(saved)} tensors ({ncache} of the AMG cache), "
         f"{size:.1f} MiB, save {t_save:.3f} s, load {t_load:.3f} s, round trip bitwise: "
         f"{exact}; one more step from saved and restored: x {rx:.3e}, v {rv:.3e} relative, "
         f"bit-equal: {bits}")
    if not exact or ncache == 0 or rx > 1e-6 or rv > 1e-6:
        fail("(d) the checkpoint round trip or the resumed step is off")
    del a, b, restored, state1, state2
    torch.cuda.empty_cache()

    # (e) one dump frame through the Python and the native writer (which
    # raises when the native library cannot be built)
    cols = ("id", "type", "x", "y", "vx", "vy", "pressure")
    with tempfile.TemporaryDirectory() as tmp:
        p_py, p_nat = os.path.join(tmp, "py.dump"), os.path.join(tmp, "native.dump")
        t0 = time.perf_counter()
        with open(p_py, "w") as f:
            dump.write_dump(f, state3, sim.domain, 3, cols)
        t_py = time.perf_counter() - t0
        t0 = time.perf_counter()
        dump.write_dump_native(p_nat, state3, sim.domain, 3, cols)
        t_nat = time.perf_counter() - t0
        fa, fb = dump.read_dump_frames(p_py)[0], dump.read_dump_frames(p_nat)[0]
    same = (fa["columns"] == fb["columns"] and fa["timestep"] == fb["timestep"] == 3
            and np.array_equal(fa["data"], fb["data"]))
    _log(f"walls (e): one frame of {fa['data'].shape[0]} particles x {len(cols)} columns: "
         f"Python writer {t_py:.3f} s, native writer {t_nat:.3f} s; values equal: {same}")
    if not same or fa["data"].shape[0] != int(state3.valid.sum()):
        fail("(e) the two dump writers disagree")

    # (f) diagnostics on the channel after (b)
    _, geom, pre = _geometry(sim, state3)
    trac = diag.traction_vector(state3, geom, pre, sim.cfg)
    lower = solid & (state3.x[1] < 0)
    drag, lift = diag.drag_lift(state3, geom, pre, sim.cfg, lower)
    div = diag.velocity_divergence(state3, geom, pre, sim.cfg)[fluid].abs().max()
    curl = diag.velocity_curl(state3, geom, pre, sim.cfg)
    const = torch.full((state3.n,), 2.5, dtype=state3.dtype, device=dev)
    smooth = _rel(diag.smooth_field(state3, geom, pre, const), const)
    _log(f"walls (f): traction on {int(solid.sum())} wall rows finite: "
         f"{bool(torch.isfinite(trac[:, solid]).all())}; lower wall drag {float(drag):.6e} "
         f"lift {float(lift):.6e} (the fluid's drag on the wall runs with the flow, the wall's "
         f"friction against it); max |div v| on fluid rows {float(div):.6e}; curl finite "
         f"{bool(torch.isfinite(curl).all())}; smooth_field of a constant {smooth:.2e} "
         "(bar 1e-6)")
    if not (bool(torch.isfinite(trac[:, solid]).all()) and float(drag) * vx > 0
            and bool(torch.isfinite(curl).all()) and smooth <= 1e-6):
        fail("(f) a wall diagnostic is off")
    del state3, state, geom, pre
    torch.cuda.empty_cache()

    # (c) the scalar Navier-slip rows: friction lowers the kinetic energy
    kes = {}
    for beta in (0.0, 5.0):
        sim_c, st = _slip_channel(dev, boundary=BoundaryCond.NAVIER_SLIP, beta=beta)
        st, aux_c = sim_c.run(st, 1)
        fl = st.is_fluid & st.valid
        kes[beta] = float((st.v[:, fl].double() ** 2).sum())
        _log(f"walls (c): scalar Navier-slip beta {beta}: helmholtz_iters "
             f"{int(aux_c.helmholtz_iters)} relres {float(aux_c.helmholtz_relres):.3e}, "
             f"kinetic energy sum {kes[beta]:.9e}")
    if not kes[5.0] < kes[0.0]:
        fail("(c) wall friction did not lower the kinetic energy")
    if failures:
        raise RuntimeError(f"phase 16: {len(failures)} checks failed: {failures}")
    return launches


# the flagship deck of phases 17-18: two-phase flow through a bead pack at the
# deck's own size (multiphase-pore-scale-flow-b-3d.lmp: N = 96 across the
# cylinder)
PORE_DECK = "multiphase-pore-scale-flow-b-3d"
PORE_N = 96


def _pore3d(dev, **kw):
    """multiphase-pore-scale-flow-b-3d at N = 96: 703,040 particles, K = 88
    (Quintic, h = 0.8 dx, cut = 2.4 dx), f64, by default the deck's SI
    parameters (rho 997.561, nu 8.9087e-7, g 9.8, alpha 0.026, theta 10
    degrees, kappa_max 1e4, shift 0.07, MorrisHolmes walls on the carved
    cylinder), its phase injection and ignore band; ``kw`` overrides
    builder arguments."""
    from isph_tpu_torch.models import decks

    return decks.build_deck(PORE_DECK, n=PORE_N, device=dev, **kw)


# tests/test_decks.py:380-381's gentler regime of the same deck (recorded)
PORE_GENTLE = dict(g=1.0, rho=1.0, nu=2e-4, alpha=1e-4)


def _pore3d_record(dev, nsteps=3, **kw):
    """The deck as it stands (``kw`` builder overrides), stepped until a
    step overflows (far-flung positions land in no cell) or leaves
    non-finite fields: a record of where it diverges, not a check.  With
    the reference's antisymmetric momentum-preserving pressure gradient
    the projection amplifies a mode near the walls and beads about tenfold
    a step, with or without surface tension and at any dt tried; the JAX
    package's step does the same (on the CPU at n = 32 both diverge at
    step 4 with the same velocities: scripts/pore_deck_variants.py and
    scripts/pore_deck_jax.py)."""
    sim, state = _pore3d(dev, **kw)
    fluid = state.is_fluid & state.valid
    for k in range(nsteps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = sim.step(state)
        torch.cuda.synchronize()
        ovf = int(aux.neighbor_overflow)
        finite = all(bool(torch.isfinite(t).all()) for t in (state.x, state.v, state.p))
        vmax = float(state.v[:, fluid].abs().max()) if finite else float("nan")
        _log(f"pore3d record {kw or 'SI'}: step {k + 1}: {time.perf_counter() - t0:.4f} s "
             f"helmholtz_iters="
             f"{int(aux.helmholtz_iters)} poisson_iters={int(aux.poisson_iters)} "
             f"poisson_relres={float(aux.poisson_relres):.3e} overflow={ovf}, finite "
             f"{finite}, max fluid |v| {vmax:.6e}")
        if ovf or not finite:
            _log(f"pore3d record {kw or 'SI'}: diverges at step {k + 1}")
            return k + 1
    return None


def _to_cpu(obj):
    """A dataclass (state, pair geometry, computePre) with every tensor on
    the CPU; a geometry drops its slot format (the gathers do not read it)."""
    kw = {f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
          if isinstance(getattr(obj, f.name), torch.Tensor)}
    if any(f.name == "slots" for f in dataclasses.fields(obj)):
        kw["slots"] = None
    if any(f.name == "amg_cache" for f in dataclasses.fields(obj)):
        kw["amg_cache"] = None
    return dataclasses.replace(obj, **kw)


def _surface_tension_forcing(sim):
    """The breakdown's surface-tension phase: the CSF force with its ignore
    band, as Simulation.step runs it."""
    from isph_tpu_torch.physics import multiphase as mp

    def forcing(state, geom, pre, mark):
        f, kappa, _ = mp.csf_force(state, geom, pre, sim.cfg,
                                   ignore_mask=mp.ignore_phase_gradient_mask(state, sim.cfg))
        mark("surface_tension")
        return state.replace(f=f), f"; max |kappa| {float(kappa.abs().max()):.4e}"

    return forcing


def phase_pore3d(dev):
    """Phase 18: the records of the deck as it stands, in its SI and in the
    gentler regime, then three f64 steps of multiphase-pore-scale-flow-b-3d
    at its deck size in the SI parameters with the symmetric corrected
    gradient through Simulation.run; returns the launches and the step-1
    (simulation, state) for phase 17."""
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.physics import multiphase as mp

    _pore3d_record(dev)
    torch.cuda.empty_cache()
    _pore3d_record(dev, **PORE_GENTLE)
    torch.cuda.empty_cache()
    sim, state = _pore3d(dev)
    sim = dataclasses.replace(sim, cfg=sim.cfg.replace(
        ns=dataclasses.replace(sim.cfg.ns, use_momentum_preserve_operator=False)))
    cfg = sim.cfg
    solid = state.is_solid & state.valid
    fluid = state.is_fluid & state.valid
    x0 = state.x[:, solid].clone()
    ns_, st_ = cfg.ns, cfg.st
    _log(f"pore3d: {PORE_DECK} n={PORE_N} N={state.n} ({int(fluid.sum())} fluid, "
         f"{int(solid.sum())} wall and bead), K={cfg.neighbor.max_neighbors}, kernel "
         f"{cfg.kernel.type.value} h={cfg.h:.6g} cut={cfg.cut:.6g}, dt {cfg.dt:.6g}, "
         f"{cfg.dtype}; rho {float(state.rho[0]):g}, nu {float(state.nu[0]):g}, g {ns_.g}, "
         f"walls {ns_.boundary.value}, momentum-preserving gradient "
         f"{ns_.use_momentum_preserve_operator}; CSF alpha {st_.alpha} theta {st_.theta} kappa_max "
         f"{st_.kappa_max}, ignore band |y - {st_.ignore_point:g}| < "
         f"{cfg.cut * st_.ignore_thres_over_cut:.6g}; shift {cfg.shift.shift}")
    if cfg.neighbor.max_neighbors != 88 or state.dtype != torch.float64:
        raise RuntimeError("the deck should give K = 88 slots in f64")
    kept = {}
    counts = []

    def each(k, st, aux):
        counts.append(int(((st.phase == 1) & st.is_fluid & st.valid).sum()))
        if k == 0:
            kept["state"] = st

    state, aux, launches = _run_steps("pore3d", sim, state, (sc.ell_spmv, sc.take),
                                      each=each)
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the pore-scale path never launched: {launches}")
    moved = float((state.x[:, solid] - x0).abs().max())
    ulps = 4 * torch.finfo(state.dtype).eps * float(x0.abs().max())
    wall_v = float(state.v[:, solid].abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in (state.x, state.v, state.p))
    vy = float(state.v[1][fluid].mean())
    _log(f"pore3d: t={float(aux.status.time):.6g} vmax {float(aux.status.vmax):.6e}, mean "
         f"fluid vy {vy:.6e}; phase-1 fluid particles after each step {counts} (0 before); "
         f"solid displacement {moved:.3e} (wrap round-off bound {ulps:.3e}), solid speed "
         f"{wall_v:.3e}")
    if not finite:
        raise RuntimeError("non-finite x, v or p on the pore-scale path")
    if moved > ulps or wall_v != 0.0:
        raise RuntimeError("the walls or beads moved or gained velocity")
    if not (counts[0] > 0 and counts == sorted(counts)):
        raise RuntimeError(f"the injected phase did not grow from 0: {counts}")

    # the ignore band and the card-against-CPU CSF cross-check, on step 1
    st1 = kept["state"].replace(f=torch.zeros_like(kept["state"].v))
    _, geom, pre = _geometry(sim, st1)
    band = mp.ignore_phase_gradient_mask(st1, cfg)
    grad = mp.phase_gradient(st1, geom, pre, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f, kappa, normal = mp.csf_force(st1, geom, pre, cfg, ignore_mask=band)
    torch.cuda.synchronize()
    t_csf = time.perf_counter() - t0
    raw = float(grad[:, band].abs().max())
    in_band = max(float(f[:, band].abs().max()), float(kappa[band].abs().max()))
    _log(f"pore3d: ignore band holds {int(band.sum())} particles; the unmasked color "
         f"gradient there reaches {raw:.4e}, the CSF force and curvature there "
         f"{in_band:.1e}; outside, max |f| {float(f.abs().max()):.4e}; csf_force "
         f"{1e3 * t_csf:.2f} ms on the card")
    if not (raw > 0.0 and in_band == 0.0):
        raise RuntimeError("the color gradient is not zeroed inside the ignore band")
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    f_c, kappa_c, normal_c = mp.csf_force(_to_cpu(st1), _to_cpu(geom), _to_cpu(pre), cfg,
                                          ignore_mask=band.cpu())
    t_cpu = time.perf_counter() - t0
    errs = [_rel(a.cpu(), b) for a, b in ((f, f_c), (kappa, kappa_c), (normal, normal_c))]
    _log(f"pore3d: csf_force on the card against the CPU on the same step-1 state and "
         f"geometry: f {errs[0]:.3e}, kappa {errs[1]:.3e}, normal {errs[2]:.3e} relative "
         f"(bar 1e-12); CPU {t_cpu:.2f} s")
    if not max(errs) <= 1e-12:
        raise RuntimeError("csf_force on the card is off the CPU's by more than 1e-12")
    del geom, pre, grad, f, kappa, normal, f_c, kappa_c, normal_c
    torch.cuda.empty_cache()

    _breakdown_amg("pore3d", sim, state, forcing=_surface_tension_forcing(sim))
    wall, busy, nk = _idle_share(lambda: sim.run(state, 1))
    _log(f"pore3d: step 4 profiled {wall:.4f} s, device busy {busy:.4f} s over {nk} "
         f"kernels, idle share {1.0 - busy / wall:.3f}")
    if not 0.0 < busy <= wall:
        raise RuntimeError("the profiled device time is not within the step's wall time")
    return launches, sim, kept["state"]


PORE_TAKE_SHAPES = ("int32 (N,) phase", "f64 (N,) vfrac", "f64 (3,N) normal")


def phase_pore3d_kernels(dev, flush, sim, state):
    """Phase 17: take on the phase ids (int32), the Shepard volumes (f64) and
    the wall normals (f64 (3, N)) over the step-1 state's neighbor list, and
    ell_spmv (f64 C = 1) on its Poisson fluid block, against their plain
    versions as phase 3 holds them."""
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.physics import ns_projection as ns

    nbrs, geom, pre = _geometry(sim, state)
    fields = dict(zip(PORE_TAKE_SHAPES, (state.phase, pre.vfrac, pre.normal.contiguous())))
    take = _take_sweep("pore3d kernels: take", sc.take, nbrs.idx, fields, flush,
                       main_shapes=PORE_TAKE_SHAPES)
    A, _ = ns.poisson_system(state, geom, pre, sim.cfg, state.v)
    fluid = state.is_fluid & state.valid
    A_f = A.zero_rows(~fluid).with_diag(torch.where(fluid, A.diag, torch.ones_like(A.diag)))
    del A, geom
    K, n = A_f.vals.shape
    nnz = int(A_f.mask.sum().item()) + n
    live = int(A_f.slots.slot_end.to(torch.int64).sum())
    _log(f"pore3d kernels: Poisson fluid block N={n} K={K} nnz={nnz} ({live} live slots, "
         f"SpMV V={_spmv_rows_per_thread(n, 8)} in f64)")
    rng = np.random.default_rng(6)
    spmv, err = _sweep_ell("pore3d kernels: spmv", A_f, nnz, flush, rng,
                           ((torch.float64, (1,)),))
    return dict(spmv_err=err, spmv=spmv[(torch.float64, 1)], take=take["f64 (N,) vfrac"],
                take_rows=take)


def phase_droplet(dev):
    """Phase 19a: three f64 steps of square-droplet-2d at n = 256 (262,144
    particles, K = 80, pairwise Tartakovsky-Meakin, shift 0.08)."""
    from isph_tpu_torch.models import decks
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = decks.build_deck("square-droplet-2d", n=256, device=dev)
    a0 = float(decks.droplet_anisotropy(state))
    _log(f"droplet: square-droplet-2d n=256 N={state.n} K={sim.cfg.neighbor.max_neighbors}, "
         f"{sim.cfg.st.pairwise_model} s={sim.cfg.st.s}, dt {sim.cfg.dt:.6g}; anisotropy "
         f"{a0:.6f}")
    state, aux, launches = _run_steps("droplet", sim, state, (sc.ell_spmv, sc.take))
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the droplet path never launched: {launches}")
    a = float(decks.droplet_anisotropy(state))
    _log(f"droplet: anisotropy {a0:.6f} -> {a:.6f} (bar 1.5x), vmax "
         f"{float(aux.status.vmax):.6e}")
    if not (math.isfinite(a) and a <= 1.5 * a0):
        raise RuntimeError("the droplet's anisotropy grew past 1.5x its start")
    return launches


def phase_micelle(dev):
    """Phase 19b: isph-micelle at its deck size.  At the deck's rest length
    (r0 = dx, the lattice spacing) the bonds pull nothing; with r0 = 0.8 dx
    contract the chains and the fluid moves; the bond sum has no atomics,
    so two runs agree bit for bit."""
    from isph_tpu_torch.models import decks

    vmaxes = {}
    for r0f in (1.0, 0.8):
        sim, state = decks.build_deck("isph-micelle", r0_factor=r0f, device=dev)
        fb = sim.extra_force(state.replace(f=torch.zeros_like(state.v)), sim.domain)
        out, aux = sim.run(state, 1)
        again, _ = sim.run(state, 1)
        bitwise = torch.equal(out.x, again.x) and torch.equal(out.v, again.v)
        vmax = float(out.v.abs().max())
        _log(f"micelle: N={state.n}, r0 = {r0f} dx: max |bond force| {float(fb.abs().max()):.4e}, "
             f"after one step max |v| {vmax:.4e}, poisson_iters {int(aux.poisson_iters)}, "
             f"two runs bitwise equal: {bitwise}")
        if not bitwise or not bool(torch.isfinite(out.v).all()):
            raise RuntimeError("the micelle step is not finite or not repeatable bit for bit")
        vmaxes[r0f] = vmax
    if not (vmaxes[0.8] > 0.0 and vmaxes[0.8] > 10.0 * vmaxes[1.0]):
        raise RuntimeError("the bond forces did not move the fluid")


def phase_random_stress(dev, tgv_sim, tgv_state):
    """Phase 19c: the random stress for one step on phase 4's TGV-256^2 f32
    state: the tensor symmetric and traceless, the force linear in
    sqrt(kBT), the noise a function of (seed, step) alone."""
    from isph_tpu_torch.config import RandomStressConfig
    from isph_tpu_torch.physics import fluctuation as fl

    seed, step = 7, int(tgv_state.step)
    cfg1 = tgv_sim.cfg.replace(rs=RandomStressConfig(enabled=True, kbt=1.0, seed=seed))
    cfg4 = cfg1.replace(rs=RandomStressConfig(enabled=True, kbt=4.0, seed=seed))
    st = tgv_state.replace(f=torch.zeros_like(tgv_state.v))
    _, geom, pre = _geometry(tgv_sim, st)
    noise = fl.random_stress_noise(seed, step, st)
    torch.randn(1000, device=dev)  # the global stream does not enter the noise
    same = torch.equal(noise, fl.random_stress_noise(seed, step, st))
    other = not torch.equal(noise, fl.random_stress_noise(seed, step + 1, st))
    S = fl.random_stress_tensor(noise, st)
    sym = float((S[0, 1] - S[1, 0]).abs().max())
    trace = float((S[0, 0] + S[1, 1]).abs().max()) / float(S.abs().max())
    f1 = fl.random_stress_force(st, geom, pre, cfg1, noise)
    f4 = fl.random_stress_force(st, geom, pre, cfg4, noise)
    lin = _rel(f4 - st.f, 2.0 * (f1 - st.f))
    # the step itself at a gentler kBT (1e-6 in the deck's units)
    sim = dataclasses.replace(tgv_sim, cfg=cfg1.replace(
        rs=RandomStressConfig(enabled=True, kbt=1e-6, seed=seed)))
    out, aux = sim.run(tgv_state, 1)
    base, _ = tgv_sim.run(tgv_state, 1)
    dv = float((out.v - base.v).abs().max())
    _log(f"random stress: TGV-256^2 f32 step {step}, seed {seed}: noise std "
         f"{float(noise.std()):.4f}; same (seed, step) bitwise {same}, another step differs "
         f"{other}; S symmetric to {sym:.1e}, trace {trace:.1e} of max |S|; "
         f"f(kbt 4) - f0 against 2 (f(kbt 1) - f0): {lin:.3e} relative; one step with rs "
         f"(kbt 1e-6): "
         f"poisson_iters {int(aux.poisson_iters)}, max |v - v without rs| {dv:.4e}")
    if not (same and other and sym == 0.0 and trace <= 1e-6 and lin <= 1e-6):
        raise RuntimeError("the random stress failed a check")
    if not (bool(torch.isfinite(out.v).all()) and dv > 0.0):
        raise RuntimeError("the random-stress step is not finite or changed nothing")

CYL = "flow-past-cylinder-2d-mls"
CYL_N = 256
# the JAX package's f64 vmax after steps 1-3 at n = 256 (on the CPU; both
# Poisson solves stop at their 750-iteration cap, so the fields agree to
# about the relres, ~1e-7)
CYL_JAX_VMAX = (1.1780202282725939e-3, 2.4129037642273026e-3, 3.6963705518801527e-3)
CYL_CD = 1.8561873826547262  # tests/test_decks.py's n = 32, 20-step drag golden


def _ale_poisson_matrix(sim, state):
    """The ALE Poisson matrix of a state as ale_navier_stokes_step
    assembles it: -dt times the MLS Laplacian rows of the fluid (filter
    F,F; mass matrix F,ALL), solid rows diag -1 and zeroed.  Returns (the
    matrix, the pair geometry)."""
    from isph_tpu_torch.ops import mls
    from isph_tpu_torch.ops.corrected import PairFilter
    from isph_tpu_torch.state import Kind

    _, geom, _ = _geometry(sim, state)
    cfg = sim.cfg
    basis = mls.MLSBasis(dim=state.dim, order=cfg.mls.basis_order)
    Minv = mls.mass_matrix_inverse(basis, geom, cfg.cut, state.kind,
                                   PairFilter(Kind.FLUID, Kind.ALL))
    A = mls.operator_matrix(basis, geom, cfg.cut, state.kind, PairFilter(Kind.FLUID, Kind.FLUID),
                            Minv, betas=[(2, 0, 0), (0, 2, 0), (0, 0, 2)][:state.dim],
                            alpha=-cfg.dt)
    fluid = state.is_fluid & state.valid
    return A.with_diag(torch.where(fluid, A.diag, -1.0)).zero_rows(~fluid), geom


def _scoped_breakdown(tag, fn):
    """Run ``fn()`` with every named phase of the driver and the ALE step
    (utils/profiling.named_scope) bracketed by synchronizes, and log the
    host time of each (a breakdown, not a step time: the syncs add cost)."""
    import contextlib
    from collections import defaultdict

    from isph_tpu_torch.models import driver
    from isph_tpu_torch.physics import ale

    acc = defaultdict(float)
    scope = driver.named_scope

    @contextlib.contextmanager
    def timed(name, device=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with scope(name, device):
            yield
        torch.cuda.synchronize()
        acc[name] += time.perf_counter() - t0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    driver.named_scope = ale.named_scope = timed
    try:
        out = fn()
    finally:
        driver.named_scope = ale.named_scope = scope
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    parts = ", ".join(f"{k}={1e3 * v:.2f} ms ({v / total:.1%})"
                      for k, v in sorted(acc.items(), key=lambda kv: -kv[1]))
    _log(f"{tag}: breakdown {1e3 * total:.2f} ms: {parts}")
    return out


def phase_cylinder_golden(dev):
    """Phase 20: flow-past-cylinder-2d-mls at n = 32, f64, 20 steps through
    Simulation.run, held to tests/test_decks.py's drag bars; both kernels
    ran."""
    from isph_tpu_torch.models import decks
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.physics.diagnostics import drag_lift

    sim, state = decks.build_deck(CYL, n=32, device=dev)
    for w in (sc.ell_spmv, sc.take):
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, aux = sim.run(state, 20)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in (sc.ell_spmv, sc.take)}
    _, geom, pre = _geometry(sim, state)
    cd, cl = (float(t) for t in drag_lift(state, geom, pre, sim.cfg, state.is_solid))
    finite = bool(torch.isfinite(state.v).all() & torch.isfinite(state.p).all())
    relres = float(aux.poisson_relres)
    _log(f"cylinder golden: n=32 N={state.n}, 20 steps in {elapsed:.3f} s, launches {launches}; "
         f"last step poisson_iters {int(aux.poisson_iters)} relres {relres:.3e} helmholtz_iters "
         f"{int(aux.helmholtz_iters)}, overflow {int(aux.neighbor_overflow)}; Cd {cd:.10f} "
         f"(golden {CYL_CD:.10f}, {cd / CYL_CD - 1.0:+.3e}), Cl {cl:.3e}")
    if not (finite and relres < 1e-6 and int(aux.neighbor_overflow) == 0):
        raise RuntimeError("the n = 32 cylinder is not finite, converged and overflow-free")
    if not (abs(cd / CYL_CD - 1.0) < 2e-2 and abs(cl) < 0.05 * abs(cd)):
        raise RuntimeError("the n = 32 cylinder's drag or lift is off tests/test_decks.py's bars")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the cylinder path never launched: {launches}")


def phase_cylinder(dev):
    """Phase 21: three f64 steps of flow-past-cylinder-2d-mls at n = 256
    (65,536 particles, the cylinder 51 dx across) through Simulation.run,
    each Poisson relres < 1e-6 and vmax within 1e-5 of JAX's; the step
    time, iterations, peak memory, a breakdown by named phase and the idle
    share of a profiled step; then one step at n = 512, logged.  Returns
    the launches and the step-3 (simulation, state) for phase 22."""
    from isph_tpu_torch.models import decks
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = decks.build_deck(CYL, n=CYL_N, device=dev)
    solid = state.is_solid & state.valid
    sc_ = sim.cfg.solver
    _log(f"cylinder: {CYL} n={CYL_N} N={state.n} ({int(solid.sum())} solid), "
         f"K={sim.cfg.neighbor.max_neighbors}, dt {sim.cfg.dt:.6g}, f64; Jacobi GMRES"
         f"({sc_.restart}) x {sc_.max_restarts} restarts, tol {sc_.tol:g} (config precond "
         f"{sc_.precond!r} is not read by the ALE solves)")
    bad = []

    def each(k, st, aux):
        vmax = float(aux.status.vmax)
        rel = vmax / CYL_JAX_VMAX[k] - 1.0
        _log(f"cylinder: step {k + 1}: vmax {vmax:.17g} (JAX {CYL_JAX_VMAX[k]:.17g}, {rel:+.2e}), "
             f"helmholtz relres {float(aux.helmholtz_relres):.3e}")
        if not (float(aux.poisson_relres) < 1e-6 and abs(rel) < 1e-5):
            bad.append(k + 1)

    state, aux, launches = _run_steps("cylinder", sim, state, (sc.ell_spmv, sc.take),
                                      cap_check=False, each=each)
    if bad:
        raise RuntimeError(f"cylinder steps {bad}: Poisson relres >= 1e-6 or vmax off JAX's")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the cylinder path never launched: {launches}")
    _scoped_breakdown("cylinder step 4", lambda: sim.run(state, 1))
    wall, busy, nk = _idle_share(lambda: sim.run(state, 1))
    _log(f"cylinder: step 4 profiled {wall:.4f} s, device busy {busy:.4f} s over {nk} "
         f"kernels, idle share {1.0 - busy / wall:.3f}")
    if not 0.0 < busy <= wall:
        raise RuntimeError("the profiled device time is not within the step's wall time")

    sim5, st5 = decks.build_deck(CYL, n=2 * CYL_N, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st5, aux5 = sim5.run(st5, 1)
    torch.cuda.synchronize()
    _log(f"cylinder n={2 * CYL_N}: N={st5.n}, one step {time.perf_counter() - t0:.4f} s: "
         f"poisson_iters {int(aux5.poisson_iters)} relres {float(aux5.poisson_relres):.3e}, "
         f"helmholtz_iters {int(aux5.helmholtz_iters)}, vmax {float(aux5.status.vmax):.6e}, "
         f"overflow {int(aux5.neighbor_overflow)}, finite "
         f"{bool(torch.isfinite(st5.v).all())}; peak "
         f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB (a record, no bar: JAX on the "
         f"CPU stops at its 750-iteration cap, relres 3.16e-5)")
    return launches, sim, state


MLS_OPERATOR_DECKS = (("poisson-operator-2d", (256, 512), 0.6, 0.08),
                      ("poisson-operator-3d", (32, 64), 0.6, 0.08),
                      ("poisson-boundary-2d", (56, 112), 0.6, 0.1))


def phase_mls_operators(dev):
    """Phase 23: tests/test_decks.py's residual-order checks of the MLS
    operator decks on the card at larger sizes: the max residual of the
    MLS Laplacian rows applied to p = sum cos(2 x_d) against -4 p shrinks
    by a factor below 0.6 under refinement and ends under 0.08 * 8 (the
    boundary deck: 0.1 * 8, fluid rows).  Returns the 3-D n = 64 rows for
    phase 22."""
    from isph_tpu_torch.models import decks
    from isph_tpu_torch.ops import mls
    from isph_tpu_torch.ops.corrected import PairFilter
    from isph_tpu_torch.state import Kind

    keep = None
    for name, sizes, ratio, frac in MLS_OPERATOR_DECKS:
        errs = []
        for n in sizes:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            sim, state = decks.build_deck(name, n=n, device=dev)
            _, geom, _ = _geometry(sim, state)
            rth = sim.cfg.h  # MLS support = h (cut_over_h = 1)
            basis = mls.MLSBasis(dim=sim.cfg.dim, order=sim.cfg.mls.basis_order)
            filt = PairFilter(Kind.FLUID, Kind.ALL)
            Minv = mls.mass_matrix_inverse(basis, geom, rth, state.kind, filt)
            p, lap_exact = decks.mls_poisson_operator_exact(state.x)
            A = mls.operator_matrix(basis, geom, rth, state.kind, filt, Minv,
                                    betas=[(2, 0, 0), (0, 2, 0), (0, 0, 2)][:sim.cfg.dim])
            rows = state.valid if name.startswith("poisson-operator") else (
                state.is_fluid & state.valid)
            err = float((A.matvec(p) - lap_exact).abs()[rows].max())
            torch.cuda.synchronize()
            errs.append(err)
            _log(f"mls operators: {name} n={n} N={state.n} K={A.vals.shape[0]}: max residual "
                 f"{err:.6e} ({time.perf_counter() - t0:.3f} s with the build, peak "
                 f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above the "
                 f"start)")
            if name == "poisson-operator-3d" and n == sizes[-1]:
                keep = A
            del geom, Minv, A, p, lap_exact
            torch.cuda.empty_cache()
        _log(f"mls operators: {name}: ratio {errs[1] / errs[0]:.4f} (bar {ratio}), final "
             f"{errs[1]:.4e} (bar {frac * 8.0:g})")
        if not (errs[1] < ratio * errs[0] and errs[1] < frac * 8.0):
            raise RuntimeError(f"{name}: the MLS residual is off tests/test_decks.py's bars")
    return keep


MLS_TAKE_SHAPES = ("f64 (N,) p", "int32 (N,) kind")


def phase_mls_kernels(dev, flush, sim, state, A3):
    """Phase 22: ell_spmv (f64 C = 1) on the n = 256 cylinder's ALE
    Poisson matrix (phase 21's step-3 state) and on the 3-D MLS Laplacian
    of poisson-operator-3d at n = 64 (phase 23), take on the cylinder's
    pressure (f64 (N,)) and kind bitmasks (int32 (N,)), against their plain
    versions as phase 3 holds them."""
    from isph_tpu_torch.ops import spmv_cuda as sc

    rng = np.random.default_rng(9)
    A, geom = _ale_poisson_matrix(sim, state)
    fields = dict(zip(MLS_TAKE_SHAPES, (state.p, state.kind)))
    take = _take_sweep("mls kernels: take cylinder", sc.take, geom.idx, fields, flush,
                       main_shapes=MLS_TAKE_SHAPES)
    out = dict(take=take["f64 (N,) p"], take_rows=take)
    err = 0.0
    for tag, M in (("cylinder Poisson", A), ("3-D operator n=64", A3)):
        K, n = M.vals.shape
        nnz = int(M.mask.sum().item()) + n
        live = int(M.slots.slot_end.to(torch.int64).sum())
        _log(f"mls kernels: {tag} N={n} K={K} nnz={nnz} ({live} live slots, "
             f"{K * n / 1e6:.1f}M slots, SpMV V={_spmv_rows_per_thread(n, 8)} in f64)")
        rows, e = _sweep_ell(f"mls kernels: spmv {tag}", M, nnz, flush, rng,
                             ((torch.float64, (1,)),))
        err = max(err, e)
        out["spmv_cylinder" if tag.startswith("cylinder") else "spmv_3d"] = rows[
            (torch.float64, 1)]
    out["spmv_err"] = err
    return out


QEQ_SPACING = 2.17  # A: 0.098 atoms/A^3, the density of the reference's PETN crystal
# tests/test_qeq.py's two types; swa, swb and tol of LAMMPS's documented
# "fix qeq/reax 1 0.0 10.0 1.0e-6 reax/c" (QEqParams' defaults)
QEQ_PARAMS = dict(chi=(1.0, 5.0), eta=(12.0, 11.0), gamma=(0.8, 1.0), swa=0.0, swb=10.0,
                  tol=1e-6, maxiter=200)
QEQ_K = 448  # slots for the ~432 neighbors within 10 A at this density
QEQ_SIDE = 64  # 262,144 atoms
# the card's charges are held to the CPU's and to the JAX package's on the
# n_side = 16 lattice (4,096 atoms) solved to 1e-10: at tol 1e-6 the
# iterate still carries the round-off of its sum order (1.5e-9 in q between
# the port and JAX on the CPU), at 1e-10 they agree within ~1e-11
QEQ_CHECK_TOL = 1e-10
# the JAX package's two solve_qeq calls there, on the CPU in f64
# (scripts/qeq_jax_reference.py): s/t iterations, sum q^2, q[0], max, min
QEQ_JAX = ((198, 145, 2114.1025234447857, -0.6102050071681332, 1.8868242205412407,
            -2.0550288118179427),
           (207, 152, 2114.102523438305, -0.6102050072235732, 1.8868242206823025,
            -2.055028811750422))


def qeq_lattice(n_side: int, seed: int = 0):
    """(positions (N, 3), type ids (N,) int32, box length) of a simple-cubic
    lattice at QEQ_SPACING jittered by up to 0.15 A (tests/test_qeq.py's
    jitter), two types drawn at random; numpy only, so the JAX package's
    reference script builds the same atoms."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                    -1).reshape(-1, 3) * QEQ_SPACING
    grid += rng.uniform(-0.15, 0.15, grid.shape)
    return grid, rng.integers(0, 2, grid.shape[0]).astype(np.int32), n_side * QEQ_SPACING


def _with_solver(sim, **kw):
    return dataclasses.replace(sim, cfg=sim.cfg.replace(
        solver=dataclasses.replace(sim.cfg.solver, **kw)))


def _timed(fn):
    """(result, seconds) of fn() between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _ilu_against_cpu(cfg, A, b, x0, fac):
    """The step-1 Helmholtz solve with ILU(0) (a GMRES per component, as
    solve_helmholtz runs it) on the card and, on the same f32 matrix copied
    to the CPU, in the port there: factors within 1e-6 of their largest
    magnitude, iterations equal, relres within 5e-3 relative and x within
    3e-5 of max |x| (the two sum in different orders)."""
    from isph_tpu_torch.ops.ell import ELL
    from isph_tpu_torch.physics import ns_projection as ns
    from isph_tpu_torch.solvers.ilu import build_ilu0

    if A.band is not None:
        raise RuntimeError("the ILU check copies an ELL without a band window")
    Ac = ELL(A.diag.cpu(), A.vals.cpu(), A.idx.cpu(), A.mask.cpu())

    def solve(AA, F, bb, xx):
        return [ns._solve(cfg, AA, bb[c], xx[c], M_override=F.apply)[0]
                for c in range(bb.shape[0])]

    rk, tk = _timed(lambda: solve(A, fac, b, x0))
    t0 = time.perf_counter()
    fc = build_ilu0(Ac)
    rc = solve(Ac, fc, b.cpu(), x0.cpu())
    tc = time.perf_counter() - t0
    for where, res, t in (("card", rk, tk), ("CPU, with the build", rc, tc)):
        _log(f"extras ilu: step-1 Helmholtz ILU(0) GMRES on the {where}: (iterations, relres) "
             f"{[(int(r.iters), float(r.relres)) for r in res]}, {t:.2f} s")
    dfac = max(float((a.cpu() - c).abs().max() / c.abs().max())
               for a, c in ((fac.fvals, fc.fvals), (fac.udiag, fc.udiag)))
    drel = max(abs(float(k.relres) - float(c.relres)) / float(c.relres) for k, c in zip(rk, rc))
    dx = max(float((k.x.cpu() - c.x).abs().max() / c.x.abs().max()) for k, c in zip(rk, rc))
    same = all(int(k.iters) == int(c.iters) for k, c in zip(rk, rc))
    _log(f"extras ilu: card against the CPU: factors within {dfac:.3e} (bar 1e-6), iterations "
         f"equal {same}, relres within {drel:.3e} relative (bar 5e-3), x within {dx:.3e} of "
         f"max |x| (bar 3e-5)")
    if not (same and dfac <= 1e-6 and drel <= 5e-3 and dx <= 3e-5):
        raise RuntimeError("the ILU(0) Helmholtz solve on the card is off the CPU's")


def phase_solver_extras(dev, flush, main_iters, main_state):
    """Phase 24: the solver extras on the TGV-256^2 f32 main path (K = 32):
    (a) ILU(0) steps, the ILU build time and its two sweep SpMVs against
    their plain versions; (b) recycling GMRES steps beside phase 4's plain
    run; (c) pipelined CG beside CG; (d) GMRES with Chebyshev on the step-1
    Helmholtz matrix beside Jacobi."""
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.physics import ns_projection as ns
    from isph_tpu_torch.solvers.ilu import build_ilu0, row_slots
    from isph_tpu_torch.solvers.krylov import gmres
    from isph_tpu_torch.solvers.precond import chebyshev, jacobi

    wrappers = (sc.ell_spmv, sc.take)
    sim, state0 = _tgv256(dev)
    out = {}

    # (a) ILU(0) on the Helmholtz solves; the singular Poisson falls back to
    # Jacobi, as in the JAX package
    iters = []
    state, aux, out["launches_ilu"] = _run_steps(
        "extras ilu", _with_solver(sim, precond="ilu"), state0, wrappers, cap_check=False,
        each=_record_iters(iters))
    _log(f"extras ilu: (Helmholtz, Poisson) iterations a step {iters}; phase 4's Jacobi "
         f"{main_iters}; the Poisson runs on its Jacobi fallback")
    _log(f"extras ilu: step-3 Helmholtz relres {float(aux.helmholtz_relres):.3e}, Poisson "
         f"{float(aux.poisson_relres):.3e}")
    if min(out["launches_ilu"].values()) <= 0:
        raise RuntimeError(f"a kernel of the ILU path never launched: {out['launches_ilu']}")
    _check_vortex("extras ilu", aux, (2 * math.pi) ** 2)
    _, geom, pre = _geometry(sim, state0)
    A, b = ns.helmholtz_system(state0.replace(f=torch.zeros_like(state0.v)), geom, pre, sim.cfg)
    build_ilu0(A)  # warm
    fac, t_build = _timed(lambda: build_ilu0(A))
    _log(f"extras ilu: ILU(0) build (3 Chow-Patel sweeps, K = {A.vals.shape[0]}) "
         f"{t_build * 1e3:.1f} ms on the step-1 Helmholtz matrix")
    _ilu_against_cpu(_with_solver(sim, precond="ilu").cfg, A, b, state0.v, fac)
    # the factorization's gathers of row k's columns (int32) and strict-upper
    # factors (f32) through each slot a's flat (K, N) index: exact on every
    # a, timed at a = K // 2
    K = A.vals.shape[0]
    ilu_fields = {"int32 (K*N,) columns": A.idx.reshape(-1),
                  "f32 (K*N,) upper factors": (fac.fvals * fac.upper).reshape(-1)}
    for a in range(K):
        flat = row_slots(A, a)
        for name, f in ilu_fields.items():
            if not torch.equal(sc.take(f, flat), sc.take_plain(f, flat)):
                raise RuntimeError(f"extras ilu: take of the {name} through slot {a} "
                                   f"disagrees with plain")
    _log(f"extras ilu: take through the (K, N) = ({K}, {A.n}) flat index of every slot a: "
         f"columns and upper factors exact")
    take = _take_sweep("extras ilu: take", sc.take, row_slots(A, K // 2), ilu_fields, flush,
                       main_shapes=tuple(ilu_fields))
    out["take_columns"] = take["int32 (K*N,) columns"]
    out["take_upper"] = take["f32 (K*N,) upper factors"]
    rng = np.random.default_rng(24)
    n = A.n
    for tag, F, part in (("L", fac.L, fac.lower), ("U", fac.U, fac.upper)):
        nnz = int(part.sum().item()) + n
        rows, err = _sweep_ell(f"extras ilu: {tag} sweep spmv", F, nnz, flush, rng,
                               ((torch.float32, (1, 2)),))
        out[f"spmv_{tag}"], out[f"err_{tag}"] = rows[(torch.float32, 1)], err

    # (b) recycling GMRES, recycle_k = 8, beside phase 4's plain Jacobi run
    iters = []
    state, aux, out["launches_recycle"] = _run_steps(
        "extras recycle", _with_solver(sim, recycle_k=8), state0, wrappers, cap_check=False,
        each=_record_iters(iters))
    dp = float((state.p - main_state.p).abs().max() / main_state.p.abs().max())
    _log(f"extras recycle: Poisson iterations a step {[p for _, p in iters]} against phase "
         f"4's {[p for _, p in main_iters]}; p after 3 steps within {dp:.3e} of phase 4's "
         f"(relative to max |p|; bar 1e-4); U {tuple(state.solver_cache.U.shape)}")
    if not dp <= 1e-4:
        raise RuntimeError(f"recycled p off the plain run by {dp:.3e}")

    # (c) pipelined CG beside CG, both with Jacobi
    runs = {}
    for method in ("cg", "pipelined_cg"):
        iters = []
        st, aux, launched = _run_steps(f"extras {method}", _with_solver(sim, method=method),
                                       state0, wrappers, cap_check=False,
                                       each=_record_iters(iters))
        runs[method] = (st, iters, launched)
    out["launches_pipelined"] = runs["pipelined_cg"][2]
    dp = float((runs["pipelined_cg"][0].p - runs["cg"][0].p).abs().max()
               / runs["cg"][0].p.abs().max())
    _log(f"extras pipelined: (Helmholtz, Poisson) iterations {runs['pipelined_cg'][1]} "
         f"against CG's {runs['cg'][1]}; p within {dp:.3e} of CG's (relative to max |p|; "
         f"bar 3e-4)")
    if not (math.isfinite(dp) and dp <= 3e-4):
        raise RuntimeError(f"pipelined CG's p off CG's by {dp:.3e}")

    # (d) GMRES with Chebyshev(3) on the step-1 Helmholtz matrix, x component
    tol = max(sim.cfg.solver.tol, 30.0 * float(torch.finfo(b.dtype).eps))
    for name, M in (("jacobi", jacobi(A)), ("chebyshev(3)", chebyshev(A, degree=3))):
        res, t = _timed(lambda: gmres(A.matvec, b[0], state0.v[0], M=M, tol=tol))
        _log(f"extras chebyshev: GMRES with {name}: {int(res.iters)} iterations, relres "
             f"{float(res.relres):.3e}, converged {bool(res.converged)}, {t * 1e3:.1f} ms")
        if name != "jacobi" and not bool(res.converged):
            raise RuntimeError("GMRES with Chebyshev did not converge")
    return out


def _qeq_setup(n_side, device):
    """(x (3, N) f64, valid, type ids, domain, cell capacity) of
    qeq_lattice on ``device``."""
    from isph_tpu_torch.ops.neighbors import lattice_cell_capacity
    from isph_tpu_torch.state import Domain

    grid, tid, box = qeq_lattice(n_side)
    dom = Domain(lo=(0.0,) * 3, hi=(box,) * 3, periodic=(True,) * 3)
    x = torch.as_tensor(grid.T.copy(), dtype=torch.float64, device=device)
    valid = torch.ones(grid.shape[0], dtype=torch.bool, device=device)
    cap = lattice_cell_capacity(dom, QEQ_PARAMS["swb"], QEQ_SPACING)
    return x, valid, torch.as_tensor(tid, device=device), dom, cap


def _qeq_geometry(x, valid, dom, cap):
    from isph_tpu_torch.ops.kernels import get_kernel
    from isph_tpu_torch.ops.neighbors import build_neighbor_list, compute_pair_geometry

    cut = QEQ_PARAMS["swb"]
    nbrs = build_neighbor_list(x, valid, dom, cut, QEQ_K, cap)
    if int(nbrs.overflow) != 0:
        raise RuntimeError(f"QEq neighbor overflow {int(nbrs.overflow)}")
    return nbrs, compute_pair_geometry(x, nbrs, dom, get_kernel("Wendland"), cut / 2.0)


def _q_summary(res):
    q = res.state.q
    return (int(res.s_info.iters), int(res.t_info.iters), float((q * q).sum()), float(q[0]),
            float(q.max()), float(q.min()))


def _qeq_check_calls(where, ncalls):
    """``ncalls`` successive solve_qeq calls on the 4,096-atom lattice on
    ``where``, solved to QEQ_CHECK_TOL."""
    from isph_tpu_torch.physics import qeq

    params = qeq.QEqParams(**{**QEQ_PARAMS, "tol": QEQ_CHECK_TOL, "maxiter": 1000})
    x, valid, tid, dom, cap = _qeq_setup(16, where)
    _, geom = _qeq_geometry(x, valid, dom, cap)
    st = qeq.QEqState.zeros(x.shape[1], device=where)
    out = []
    for _ in range(ncalls):
        out.append(qeq.solve_qeq(geom, tid, params, st, valid))
        st = out[-1].state
    return out


def phase_qeq(dev, flush):
    """Phase 25: ReaxFF QEq on 262,144 atoms (a jittered 64^3 lattice at
    2.17 A, f64, K = 448, cutoff 10 A, tol 1e-6): six solve_qeq calls on
    fixed positions with the launch counters set to 0 before the neighbor
    build and read after the sixth; the 4,096-atom lattice on the card
    against the port on the CPU and the JAX package's constants; the kernels
    on its H (f64 C = 2) and type ids (int32)."""
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.physics import qeq

    params = qeq.QEqParams(**QEQ_PARAMS)
    x, valid, tid, dom, cap = _qeq_setup(QEQ_SIDE, dev)
    n = x.shape[1]
    for w in (sc.ell_spmv, sc.take):
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (nbrs, geom), t_nb = _timed(lambda: _qeq_geometry(x, valid, dom, cap))
    cmax = int(nbrs.count.max())
    del nbrs
    geo_peak = torch.cuda.max_memory_allocated() - base
    _log(f"qeq: N={n} K={QEQ_K} cell capacity {cap}; neighbor build and geometry "
         f"{t_nb:.3f} s, peak {geo_peak / 2**30:.2f} GiB above the positions; count.max {cmax}")
    torch.cuda.reset_peak_memory_stats()
    st = qeq.QEqState.zeros(n, device=dev)
    calls = []
    for call in range(6):
        res, t = _timed(lambda: qeq.solve_qeq(geom, tid, params, st, valid))
        st = res.state
        qsum, qabs = float(st.q.sum()), float(st.q.abs().sum())
        calls.append((int(res.s_info.iters), int(res.t_info.iters)))
        _log(f"qeq: call {call + 1}: s {calls[-1][0]} iterations relres "
             f"{float(res.s_info.relres):.3e}, t {calls[-1][1]} relres "
             f"{float(res.t_info.relres):.3e}; {t:.4f} s; sum q {qsum:.3e} (sum |q| {qabs:.6e})")
        if not (bool(res.s_info.converged) and bool(res.t_info.converged)):
            raise RuntimeError(f"QEq call {call + 1} did not converge")
        if not (abs(qsum) <= 1e-9 * qabs and bool(torch.isfinite(st.q).all())):
            raise RuntimeError(f"QEq charges not neutral: sum q {qsum:.3e}")
    launches = {"ell_spmv": sc.ell_spmv.launches, "take": sc.take.launches}
    _log(f"qeq: launches {launches}; solve peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
         f"GiB")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the QEq path never launched: {launches}")
    if calls[5][0] > calls[0][0] or calls[5][1] > calls[0][1]:
        raise RuntimeError(f"the sixth QEq call took more iterations than the first: {calls}")
    wall, busy, nk = _idle_share(lambda: qeq.solve_qeq(geom, tid, params, st, valid))
    _log(f"qeq: a seventh call profiled {wall:.4f} s, device busy {busy:.4f} s over {nk} "
         f"kernels, idle share {1.0 - busy / wall:.3f}")

    H = qeq.assemble_h(geom, tid, params, valid)
    nnz = int(H.mask.sum().item()) + n
    rng = np.random.default_rng(25)
    spmv, err = _sweep_ell("qeq: spmv", H, nnz, flush, rng, ((torch.float64, (2,)),))
    # the type ids (assemble_h) and the positions (compute_pair_geometry)
    take = _take_sweep("qeq: take", sc.take, H.idx, {"int32 (N,)": tid, "f64 (3,N)": x},
                       flush, main_shapes=("int32 (N,)", "f64 (3,N)"))
    del H, geom, st
    torch.cuda.empty_cache()

    # the 4,096-atom lattice solved to QEQ_CHECK_TOL on the card and on the
    # CPU, and against the JAX package's constants
    card, cpu = _qeq_check_calls(dev, 2), _qeq_check_calls(torch.device("cpu"), 1)
    dq = float((card[0].state.q.cpu() - cpu[0].state.q).abs().max())
    summary = [_q_summary(r) for r in card]
    _log(f"qeq check: 4,096 atoms, tol {QEQ_CHECK_TOL:.0e}: card q within {dq:.3e} of the "
         f"CPU's (bar 1e-10); card (s, t, sum q^2, q0, max, min) {summary}, JAX "
         f"{list(QEQ_JAX)}")
    if not dq <= 1e-10:
        raise RuntimeError(f"QEq on the card off the CPU by {dq:.3e}")
    # the first call, from a zero history, against JAX's: q0, max and min
    # within 1e-10, sum q^2 within 1e-10 relative
    ref = QEQ_JAX[0]
    off = max(abs(summary[0][2] - ref[2]) / ref[2],
              *(abs(a - b) for a, b in zip(summary[0][3:], ref[3:])))
    if not off <= 1e-10:
        raise RuntimeError(f"QEq on the card off the JAX package's by {off:.3e}")
    return dict(spmv=spmv[(torch.float64, 2)], take=take["int32 (N,)"],
                take_positions=take["f64 (3,N)"], spmv_err=err, launches=launches)

# ---------------------------------------------------------------------------
# phase 26: the sharded step (parallel/sharded.py) at world size 1 on NCCL
# ---------------------------------------------------------------------------

def _sharded(sim, state, group, halo=None, **kw):
    """The ShardedSimulation of ``state`` on ``group`` and this rank's slab:
    n_loc from choose_n_loc; without ``halo`` the halo holds the fuller
    face's cut layer (the particles within the cutoff of a slab face) with
    25% slack, rounded up to 128."""
    from isph_tpu_torch.parallel.sharded import (ShardedSimulation, choose_n_loc,
                                                 partition_state, slab)

    dom = sim.domain
    n_loc = choose_n_loc(state, dom, group.size)
    layer = None
    if halo is None:
        slab_w = dom.length[0] / group.size
        u = torch.remainder(dom.wrap(state.x)[0] - dom.lo[0], slab_w)[state.valid]
        layer = (int((u < sim.cfg.cut).sum()), int((u >= slab_w - sim.cfg.cut).sum()))
        halo = -(-int(math.ceil(1.25 * max(layer))) // 128) * 128
    ss = ShardedSimulation(sim=sim, group=group, n_loc=n_loc, halo=halo, **kw)
    st = slab(partition_state(state, dom, group.size, n_loc), group.rank, n_loc)
    return ss, ss.prepare(st), layer


def _vcycles(ss, st):
    """(V-cycles, their ms) of one more sharded step, each V-cycle bracketed
    by synchronizes."""
    from isph_tpu_torch.solvers import amg

    apply = amg.AMG.apply
    spent = []

    def timed(self, r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply(self, r)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    amg.AMG.apply = timed
    try:
        ss.step(st)
    finally:
        amg.AMG.apply = apply
    return len(spent), 1e3 * sum(spent)


def _sharded_kernels(flush, ss, st):
    """The kernels of the sharded step at the slab's shapes, against their
    plain versions as in phase 3.  On the world-size-1 path: ell_spmv on the
    Poisson matrix of the extended slab (n_loc + 2H rows, halo columns live)
    and take on the slab's neighbor list (f32 (N,), (2,N)).  Off that path
    (matvec_overlapped runs at world size > 1 only), at the same shapes:
    the SpMV of A_own (halo-column values zeroed) and the (K, 2H)
    boundary-strip take, whose bound reads only the distinct columns it
    gathers."""
    from isph_tpu_torch.ops import corrected as ops
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.ops.ell import ELL
    from isph_tpu_torch.state import Kind

    ext, comm, geom, pre, _ = ss._borders(st, *ss._slab_bounds(st.dtype, st.device))
    A = ops.laplacian_matrix(
        geom, pre.vfrac, pre.Gc, pre.Lc, ext.kind, alpha=-ss.cfg.dt,
        material=1.0 / ext.rho, filt=ops.PairFilter(Kind.FLUID, Kind.FLUID),
        family=ops.SYMMETRIC)
    own = (A.idx < ss.n_loc).to(A.vals.dtype)
    A_own = ELL(A.diag, A.vals * own, A.idx, A.mask, A.band, A.slots)
    K, n = A.vals.shape
    nnz = int(A.mask.sum().item()) + n
    _log(f"sharded kernels: A N={n} (n_loc {ss.n_loc} + 2 x halo {ss.halo}) K={K} "
         f"nnz={nnz}, {int((own * A.mask).sum().item())} on owned columns")
    rng = np.random.default_rng(26)
    both = ((torch.float32, (1,)), (torch.float64, (1,)))
    spmv, err = _sweep_ell("sharded kernels: A spmv (the path's)", A, nnz, flush, rng, both)
    spmv_own, err_own = _sweep_ell("sharded kernels: A_own spmv (world size > 1)", A_own, nnz,
                                   flush, rng, both)
    fields = {f"{t} ({'N,' if c == 1 else f'{c},N'})": _field(
        rng, (n,) if c == 1 else (c, n), dt, st.device)
        for t, dt in (("f32", torch.float32), ("f64", torch.float64)) for c in (1, 2)}
    take = _take_sweep(f"sharded kernels: take (the path's, K={K}, N={n})", sc.take, geom.idx,
                       {k: fields[k] for k in ("f32 (N,)", "f32 (2,N)")}, flush,
                       main_shapes=("f32 (N,)", "f32 (2,N)"))
    rows = torch.cat([comm.spec.send_left, comm.spec.send_right])
    idx_s = geom.idx[:, rows].contiguous()
    cols = int(torch.unique(idx_s).numel())
    strip = _take_sweep(f"sharded kernels: strip take (world size > 1, K={K}, "
                        f"2H={idx_s.shape[1]}, {cols} distinct columns)", sc.take, idx_s,
                        fields, flush, main_shapes=("f32 (N,)",), x_read=cols)
    return dict(spmv=spmv[(torch.float32, 1)], spmv_own=spmv_own[(torch.float32, 1)],
                spmv_err=max(err, err_own), take=take["f32 (N,)"], take_strip=strip["f32 (N,)"])


def _matched(fields_a, fields_b, names):
    """max |a - b| of each field after matching the valid particles by
    position."""
    out = {}
    sorted_ = []
    for f in (fields_a, fields_b):
        v = f["valid"].astype(bool)
        x = f["x"][:, v]
        o = np.lexsort([np.round(x[d] * 1e6).astype(np.int64) for d in reversed(range(len(x)))])
        sorted_.append({k: f[k][..., v][..., o] for k in names})
    for k in names:
        out[k] = float(np.abs(sorted_[0][k] - sorted_[1][k]).max())
    return out


def _sharded_exact(dev, group):
    """(b) TGV-256^2 f64, h_factor 1.6, Jacobi: the sharded step at world
    size 1 against the one-device step on the card.  Step 1 from the same
    initial state: fields within 1e-9 after matching by position, both
    runs' iterations and relres logged (the step's Poisson right-hand side
    is round-off, since the initial field is divergence-free, and Jacobi
    GMRES may take another count on it).  Steps 2-4 from a common state,
    the one-device state after step 1: iterations equal, fields within 1e-9
    after step 4."""
    from isph_tpu_torch import interop
    from isph_tpu_torch.models import tgv

    sim, state = tgv.make_tgv(256, h_factor=1.6, device=dev)
    sim = dataclasses.replace(sim, cfg=sim.cfg.replace(
        solver=dataclasses.replace(sim.cfg.solver, precond="jacobi")))
    state = sim.prepare(state)
    names = ("x", "v", "p")

    def counts(aux):
        return (int(aux.helmholtz_iters), int(aux.poisson_iters),
                f"{float(aux.poisson_relres):.3e}")

    ss, st, layer = _sharded(sim, state, group)
    st, saux = ss.step(st)
    state, raux = sim.step(state)
    diff = _matched(interop.state_to_numpy(st), interop.state_to_numpy(state), names)
    _log(f"sharded exact: step 1 from the same initial state: (helmholtz, poisson, poisson "
         f"relres) one device {counts(raux)}, sharded {counts(saux)}; max |sharded - one "
         f"device| {diff}")
    if max(diff.values()) > 1e-9 or int(saux.neighbor_overflow) != 0:
        raise RuntimeError(f"sharded step 1 differs from the one-device step: {diff}")
    ss, st, _ = _sharded(sim, state, group)
    ref = state
    for k in range(3):
        ref, raux = sim.step(ref)
        st, saux = ss.step(st)
        a, b = counts(raux), counts(saux)
        _log(f"sharded exact: step {k + 2}: (helmholtz, poisson, poisson relres) one device "
             f"{a}, sharded {b}")
        if a[:2] != b[:2] or int(saux.neighbor_overflow) != 0:
            raise RuntimeError(f"sharded step {k + 2} iterations {b} != one device's {a}")
    diff = _matched(interop.state_to_numpy(st), interop.state_to_numpy(ref), names)
    _log(f"sharded exact: TGV-256^2 f64 halo {ss.halo} (cut layer {layer}): max |sharded - "
         f"one device| after step 4 {diff}")
    if max(diff.values()) > 1e-9:
        raise RuntimeError(f"sharded step differs from the one-device step: {diff}")


def _event_ms(fn, reps=5):
    """Median ms of ``fn()`` between two CUDA events, after one warm call."""
    fn()
    ms = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    return statistics.median(ms)


def _sharded_overhead_128(dev, group):
    """(c) bench.py:bench_sharded_overhead's cell: TGV-128^2 f32 Jacobi,
    K = 32, halo 640, n_loc = N: the sharded step over the plain one, both
    timed with CUDA events from the same state."""
    from isph_tpu_torch.parallel.sharded import ShardedSimulation, partition_state, slab

    sim, state = _tgv(dev, 128, "jacobi")
    n = state.n
    ss = ShardedSimulation(sim=sim, group=group, n_loc=n, halo=640, migrate_cap=256)
    st = ss.prepare(slab(partition_state(state, sim.domain, 1, n), 0, n))
    plain = _event_ms(lambda: sim.step(state))
    sharded = _event_ms(lambda: ss.step(st))
    ratio = sharded / plain
    _log(f"sharded: TGV-128^2 f32 Jacobi K=32 halo 640: sharded step {sharded:.3f} ms, "
         f"plain step {plain:.3f} ms (CUDA events, median of 5); "
         f"sharded_overhead_ratio={ratio:.4f}")
    return ratio


def phase_sharded(dev, flush, large):
    """Phase 26: the sharded step at world size 1 on NCCL, in-process."""
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.parallel import mesh

    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    group = mesh.make_mesh(1, 0, backend="nccl", init_file=os.path.join(store, "store"),
                           device=dev)
    try:
        # (a) the 1M step at full width: phase 7's lattice and AMG, the AMG
        # cache on as phase 7's one-device driver caches
        sim, state = _tgv1024(dev)
        ss, st, layer = _sharded(sim, state, group, amg_cache_enabled=True)
        _log(f"sharded: world size 1 on NCCL; TGV-1024^2 f32 AMG: n_loc={ss.n_loc} "
             f"halo={ss.halo} (cut layer {layer[0]} and {layer[1]} particles at the two "
             f"x-faces, cut {sim.cfg.cut:.6f}), local cell capacity "
             f"{ss._local_cell_capacity()}")
        iters, step_s = [], []
        st, aux, launches = _run_steps("sharded", sim, st, (sc.ell_spmv, sc.take),
                                       each=_record_iters(iters), step_times=step_s,
                                       step=ss.step)
        peak = torch.cuda.max_memory_allocated() / 2**20
        if min(launches.values()) <= 0:
            raise RuntimeError(f"a kernel never launched on the sharded path: {launches}")
        ke, vmax = float(aux.status.kinetic_energy), float(aux.status.vmax)
        d_ke, d_v = abs(ke / large["ke"] - 1.0), abs(vmax / large["vmax"] - 1.0)
        med = statistics.median(step_s[1:])
        _log(f"sharded: KE {ke!r} (phase 7 {large['ke']!r}, rel {d_ke:.3e}), vmax {vmax!r} "
             f"(phase 7 {large['vmax']!r}, rel {d_v:.3e}), nfluid {float(aux.status.nfluid)!r}; "
             f"(helmholtz, poisson) iterations {iters} beside phase 7's {large['iters']}; "
             f"peak memory {peak:.1f} MiB")
        if max(d_ke, d_v) > 1e-4 or float(aux.status.nfluid) != large["nfluid"]:
            raise RuntimeError("the sharded 1M step departs from phase 7's")
        _log(f"sharded: sharded_overhead_ratio_1m={med / large['median_s']:.4f} "
             f"(sharded median {med:.4f} s / phase 7 median {large['median_s']:.4f} s)")
        nv, vms = _vcycles(ss, st)
        _log(f"sharded: one more step: {nv} V-cycles, {vms:.1f} ms, "
             f"{vms / max(nv, 1):.3f} ms each")
        wall, busy, nk = _idle_share(lambda: ss.step(st))
        _log(f"sharded: profiled step {wall:.4f} s, device busy {busy:.4f} s over {nk} "
             f"kernels, idle share {1.0 - busy / wall:.3f}")
        kd = _sharded_kernels(flush, ss, st)
        del sim, state, ss, st, aux
        torch.cuda.empty_cache()
        # (b) exactness; (c) the reference's yardstick
        _sharded_exact(dev, group)
        _sharded_overhead_128(dev, group)
    finally:
        mesh.close_mesh()
    return dict(launches=launches, **kd)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA device", file=sys.stderr)
        return 2
    from isph_tpu_torch import _build

    # phase 1: device
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    _log(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
         f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    _log(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    log_file = lib_path.with_suffix(".log")
    if log_file.exists():
        report = log_file.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = [ln.strip() for ln in report.splitlines()
                  if "spill" in ln and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", ln)]
        _log(f"build: {len(regs)} kernel instantiations, registers {min(regs)}-{max(regs)}, "
             f"spills: {spills or 'none'}")

    # phase 3: kernels against their plain versions (L2-sized flush buffer)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    k = phase_kernels(dev, flush)
    del flush

    # phase 4: main path; phase 5: golden
    launches, tgv_sim, tgv_state, tgv_t, main_iters = phase_main_path(dev)
    phase_golden(dev)

    # phase 6: band kernels at 1M; phase 7: the large-N path
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    kb = phase_band_kernels(dev, flush)
    del flush
    torch.cuda.empty_cache()
    launches_large, large = phase_large_n(dev)

    # phase 8: 3-D kernels; phase 9: the 3-D path; phase 10: channel
    # kernels; phase 11: the channel path
    torch.cuda.empty_cache()
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    k3 = phase_3d_kernels(dev, flush)
    del flush
    torch.cuda.empty_cache()
    launches_3d = phase_3d_path(dev)
    torch.cuda.empty_cache()
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    kc = phase_channel_kernels(dev, flush)
    del flush
    torch.cuda.empty_cache()
    launches_channel = phase_channel(dev)

    # phase 12: electrokinetic kernels; phase 13: electrokinetic goldens;
    # phase 14: the electroosmotic channel; phase 15: transport
    torch.cuda.empty_cache()
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    ke = phase_edl_kernels(dev, flush)
    del flush
    torch.cuda.empty_cache()
    phase_edl_golden(dev)
    launches_edl = phase_edl_path(dev)
    torch.cuda.empty_cache()
    launches_transport = phase_transport(dev)

    # phase 16: walls and entry points
    torch.cuda.empty_cache()
    launches_walls = phase_walls(dev, tgv_sim, tgv_state, tgv_t)

    # phase 18: the 3-D multiphase pore-scale deck at its own size; phase 17:
    # the kernels on its step-1 state; phase 19: the droplet, the micelle
    # and the random stress
    torch.cuda.empty_cache()
    launches_pore3d, pore_sim, pore_state = phase_pore3d(dev)
    torch.cuda.empty_cache()
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    kp = phase_pore3d_kernels(dev, flush, pore_sim, pore_state)
    del flush, pore_sim, pore_state
    torch.cuda.empty_cache()
    launches_droplet = phase_droplet(dev)
    phase_micelle(dev)
    phase_random_stress(dev, tgv_sim, tgv_state)

    # phase 20: the n = 32 cylinder golden; phase 21: the cylinder at size;
    # phase 23: the MLS operator decks; phase 22: the kernels on the
    # cylinder's and the 3-D operator deck's matrices
    torch.cuda.empty_cache()
    phase_cylinder_golden(dev)
    launches_cyl, cyl_sim, cyl_state = phase_cylinder(dev)
    torch.cuda.empty_cache()
    A3 = phase_mls_operators(dev)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    km = phase_mls_kernels(dev, flush, cyl_sim, cyl_state, A3)
    del flush, A3, cyl_sim, cyl_state

    # phase 24: the solver extras on the main path; phase 25: QEq at size
    torch.cuda.empty_cache()
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    kx = phase_solver_extras(dev, flush, main_iters, tgv_state)
    kq = phase_qeq(dev, flush)

    # phase 26: the sharded step at world size 1 on NCCL
    torch.cuda.empty_cache()
    ks = phase_sharded(dev, flush, large)
    del flush

    def row(name, source, replaces, launched, err, t):
        return dict(name=name, route="cuda", source=f"isph_tpu_torch/csrc/{source}",
                    replaces=f"isph_tpu/ops/spmv_pallas.py:{replaces}", launches=launched,
                    max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"])

    def times(t):
        return {key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    def beyond(name):
        """The launches on phases 9, 11, 14-16, 18, 19a and 21, the f32 (N,)
        rows of phases 8 (64^3) and 10 (the channel's Poisson matrix) and the
        f64 rows of phases 12 (the PB Jacobian), 17 (the pore-scale deck's
        Poisson fluid block, its Shepard volumes) and 22 (the cylinder's ALE
        Poisson matrix and pressure; the 3-D MLS Laplacian); phase 24's ILU
        sweeps (f32, the L and U factors on the TGV-256^2 Helmholtz matrix)
        and the factorization's gathers (f32 upper factors, int32 columns,
        through a (K, N) flat index into K*N values), with the launches of
        its ILU, recycled and pipelined runs; phase 25's QEq matrix (f64
        C = 2, K = 448), type ids (int32) and positions (f64 (3, N)) with
        the launches of its six solves; phase 26's Poisson matrix of the
        extended slab (f32) and the slab's neighbor gather (f32 (N,)), the
        kernels of the world-size-1 path, with the launches of its three 1M
        sharded steps, and beside them the world-size > 1 shapes: A_own
        (f32) and the boundary strip (f32 (N,))."""
        kname = "spmv" if name == "ell_spmv" else name
        mls_rows = (dict(at_cylinder=times(km["spmv_cylinder"]),
                         at_mls_3d=times(km["spmv_3d"])) if name == "ell_spmv"
                    else dict(at_cylinder=times(km["take"])))
        extras = (dict(at_ilu=times(kx["spmv_L"]), at_ilu_upper=times(kx["spmv_U"]),
                       at_qeq=times(kq["spmv"]), at_sharded=times(ks["spmv"]),
                       at_sharded_own=times(ks["spmv_own"]))
                  if name == "ell_spmv"
                  else dict(at_ilu=times(kx["take_upper"]),
                            at_ilu_columns=times(kx["take_columns"]),
                            at_qeq=times(kq["take"]),
                            at_qeq_positions=times(kq["take_positions"]),
                            at_sharded=times(ks["take"]),
                            at_sharded_strip=times(ks["take_strip"])))
        return dict(launches_3d=launches_3d[name], launches_channel=launches_channel[name],
                    launches_ilu=kx["launches_ilu"][name],
                    launches_recycle=kx["launches_recycle"][name],
                    launches_pipelined=kx["launches_pipelined"][name],
                    launches_qeq=kq["launches"][name],
                    launches_sharded=ks["launches"][name], **extras,
                    launches_edl=launches_edl[name],
                    launches_transport=launches_transport[name],
                    launches_walls=launches_walls[name],
                    launches_pore3d=launches_pore3d[name],
                    launches_droplet=launches_droplet[name],
                    launches_cylinder=launches_cyl[name],
                    at_64cubed=times(k3["rows"][64][kname]), at_channel=times(kc[kname]),
                    at_edl=times(ke[kname]), at_pore3d=times(kp[kname]), **mls_rows)

    kernels = [
        {**row("ell_spmv", "spmv.cu", 298, launches["ell_spmv"],
               max(k["spmv_err"], kb["spmv32_err"], k3["spmv_err"], kc["spmv_err"],
                   ke["spmv_err"], kp["spmv_err"], km["spmv_err"], kx["err_L"], kx["err_U"],
                   kq["spmv_err"], ks["spmv_err"]), k["spmv"]),
         **beyond("ell_spmv")},
        {**row("take", "take.cu", 332, launches["take"], 0.0, k["take"]), **beyond("take")},
        row("ell_spmv_band", "spmv_band.cu", 458, launches_large["ell_spmv_band"],
            kb["spmv_err"], kb["spmv"]),
        row("take_band", "take_band.cu", 635, launches_large["take_band"], 0.0, kb["take"]),
    ]
    print(_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
