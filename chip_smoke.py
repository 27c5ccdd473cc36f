#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (isph_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It checks the port on the card and times its kernels, not its steps
(phase 28 checks the port's bench, which times bench.py's own small
cells).  The configurations' steps are measured only by the benchmark,
``python3 -m benchmark.run``, and their phases by the step's named_scope
ranges and spans in its ``--trace 1`` runs.

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
   Jacobi through Simulation.run, one step per call (the same steps as
   run(state, 3)), with the launch counters reset just before and read
   just after; checks overflow, finiteness, volume,
   the decaying vmax, that the ELL kernels and the compensated dot ran,
   and that each step's Helmholtz and Poisson counts and vmax bits are
   MAIN_PARENT's on the card (the compensated dot keeps the cascade's
   bits; the correction-tensor kernel set its own f32 bits);
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
   and that both band kernels ran; logs the peak device memory;
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
   both kernels ran; logs the neighbor build's own peak, the steps' peak
   device memory and the Poisson iterations of a fourth Simulation.step
   with AMG beside the same step with Jacobi;
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
   kernels ran;
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
   its Newton iterations and NormF; at n = 512 (53,448
   particles) the reference's Newton does not converge (JAX's stops at
   its cap of 100 too), and the script logs the same numbers; applied-efield-potential-2d
   at n = 64: its error against the Henry field within 1e-6 relative of
   the JAX package's (henry-efield-2d, whose GMRES stalls in both
   packages, is logged only);
14. electroosmotic channel: three f64 steps of channel-edl-linear-2d at
   n = 512 (268,288 particles, linearized PB, eps = 0.02, default AMG)
   through Simulation.run; checks overflow, finiteness, fixed walls, the
   flow in -x and that both kernels ran; the PB Newton solve of the first
   step (solve_poisson_boltzmann on the start state) held to NormF <= tol_f
   (1e-8); then one f32 step of the same deck through Simulation.run, in
   which comp_dots must launch (its Newton runs to its cap: the absolute
   stopping test lies below f32 round-off);
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
   logs the dt sequence, each step's iterations, the launches and the peak
   memory; (d) a checkpoint after step 2 restored into the step-1 state
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
   of the step-1 state and geometry within 1e-12; the peak memory;
19. the other new paths: three f64 steps of square-droplet-2d at n = 256
   (262,144 particles, K = 80, pairwise Tartakovsky-Meakin; the drop's
   anisotropy stays within 1.5x its start); isph-micelle at its deck size
   (bonds through extra_force: at the rest length nothing moves, at
   0.8 dx the fluid does, and two runs agree bit for bit); the random
   stress for one step on phase 4's state (the tensor symmetric and
   traceless, the force linear in sqrt(kBT), the noise a function of
   (seed, step) alone); JAX's threefry
   stream (utils/threefry.py) on the card against the CPU's for a
   (2, 2, 65536) and a (3, 3, 703,040) draw: the 32- and 64-bit words
   bitwise, the f32 and f64 normals within 2 ulp, each draw timed; three
   f64 TGV-32 steps with the random stress (seed 7, kbt 0.01) against the
   JAX package's CPU values (RS_JAX): counts equal, KE and vmax within
   1e-9 relative;
20. the MLS/ALE golden: flow-past-cylinder-2d-mls at n = 32, f64, 20
   steps through Simulation.run, held to tests/test_decks.py's bars
   (finite fields, Poisson relres < 1e-6, no overflow, Cd within 2% of
   1.8561873826547262, |Cl| < 5% of Cd); both kernels ran;
21. the cylinder at size: n = 256 (65,536 particles, the cylinder 51 dx
   across, K = 48, f64), three steps through Simulation.run, each Poisson
   relres < 1e-6 and vmax within 1e-5 relative of the JAX package's (its
   Jacobi GMRES(50) stops at the 750-iteration cap in both packages); the
   iterations, the peak memory and a fourth step without overflow and
   finite; then one step at n = 512 (262,144 particles), its iterations
   and relres logged;
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
   the tolerance); the step-1 ILU solve on the card against the port on
   the CPU on the same f32 matrix (factors within 1e-6, iterations equal,
   relres within 5e-3 relative, x within 3e-5 of max |x|); the
   factorization's take through the flat (K, N) index of every slot exact
   against take_plain, and its L and U sweep SpMVs (zero diagonal, f32
   C = 1 and 2) against their plain versions as in phase 3, with bounds,
   plain and library times; (b)
   three steps with recycle_k = 8, p within 1e-4 of max |p| of phase 4's;
   (c) three steps of pipelined CG beside three of CG, both Jacobi, p
   within 3e-4; (d) GMRES with chebyshev(degree=3) on the step-1 Helmholtz
   matrix beside Jacobi, which must converge;
25. ReaxFF QEq at the size users run: 262,144 atoms on a jittered 64^3
   lattice at 2.17 A (0.098 atoms/A^3, the reference's PETN crystal), f64,
   two types, K = 448, cutoff 10 A and tol 1e-6 (LAMMPS's documented
   fix qeq/reax 1 0.0 10.0 1.0e-6); six solve_qeq calls on fixed
   positions, each converged and neutral, the sixth in no more iterations
   than the first, with the neighbor build's and the solves' peaks and the
   launches; the SpMV on H (f64
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
   ran; the iterations beside phase 7's, the peak memory; (d) the kernels
   of the overlapped matvec at (a)'s shapes: the SpMV of A_own (the slab's
   Poisson matrix, halo-column values zeroed; f32 and f64 C = 1) and the
   (K, 2H) boundary-strip take (f32, f64 at (N,) and (2, N)) against
   their plain versions as in phase 3; (b) TGV-256^2 f64 h_factor 1.6 Jacobi from a
   common first step (its Poisson right-hand side is round-off), three
   sharded steps against the one-device steps: iterations equal, fields
   within 1e-9 after matching by position; (e)
   scripts/weak_scaling.py's world-size-1 layout (TGV-32 f64, h_factor
   1.6, n_loc = halo = 1536): three steps against JAX's sharded step
   (WEAK_JAX), Helmholtz counts equal, Poisson counts from step 2 (step
   1's right-hand side is round-off; its count is logged beside JAX's),
   KE and vmax within 1e-9 relative;
27. the rest of the distributed layer at world size 1 on NCCL, in this
   process, the launch counters set to 0 around each part: (a) three
   steps of phase 21's n = 256 cylinder (f64, K = 48, fully periodic)
   through ShardedSimulation.step (n_loc from choose_n_loc, the halo the
   cut layer + 25%), each Poisson relres < 1e-6 and vmax within 1e-5 of
   JAX's, no overflow, both kernels ran; the iterations beside phase 21's,
   the peak memory and the collectives of a fourth step; (b) phase
   25's 262,144-atom QEq lattice as one slab (n_loc = N): solve_qeq with
   the halo refresh and the group against the one-device solve on the
   same atoms at 1e-10 (q within 1e-10, s/t iterations equal), then two
   calls at 1e-6 with their collectives;
   (d) ell_spmv on the extended slabs' ALE Poisson matrix (f64 C = 1) and
   QEq H (f64 C = 2), take on the ALE slab list (f64 pressure, int32
   kinds) and the QEq slab's type ids (int32), against their plain
   versions as in phase 3; the group closed, then (c)
   entry.dryrun_multichip on every card, one NCCL rank each;
28. the port's bench (isph_tpu_torch/bench.py, ``python -m
   isph_tpu_torch.bench``) with its --small set, in this process, the
   launch counters set to 0 around it: bench.py's line with every key of
   its small set (bench.SMALL_KEYS), the numbers finite and positive, the
   device named as nvidia-smi names it, ell_spmv, take and comp_dots
   launched;
29. (run after phase 3) the compensated dot kernel (csrc/comp_dot.cu)
   against the plain cascade of utils/fsum.py run on the same CUDA
   tensors, bit for bit (the f32 words of every (hi, lo, hi + lo), no
   tolerance), with one launch a call, at N = 16,384, 65,536, 262,144,
   1,048,576, 1,318,400 (the sharded 1M slab), 50,001 and 1, on (C, N)
   rows with C = 2 and 3 and on stacks of 4 pairs (N = 65,536) and 3
   pairs (1M); values across 12 decades; each timed beside its bound (the
   inputs read once at the HBM rate), the plain cascade, one library call
   (torch.dot or torch.linalg.vecdot: a plain f32 sum, other bits) and an
   empty launch, with the host's enqueue time of a call; one call
   captured in a CUDA graph at N = 1, 16,384, 65,536 and 1M, C = 3 and 3
   pairs at 1M, each replayed three times on fresh inputs copied into
   the captured tensors, bitwise equal to the plain cascade, the ticket
   counters at 0 after every replay.  comp_dots is also counted, and
   required to launch, on every phase that runs an f32 Krylov solve: 4,
   5, 7, 9, 11, 14 (its f32 step), 16(b), 19c, 24, 26 and 28;
30. (run after phase 29) the AMG transfer kernels (csrc/agg_transfer.cu)
   at the cells' shapes, f32: the 1M cell's level 0 (12,769 aggregates of
   ~82 rows of a 1024^2 lattice) and level 1 (1,369 of ~9, the grid
   parents), 64^3's (64 of 4,096) and the 1M Galerkin build's C = 10
   rows: restrict the same bits on two calls, one launch each, within
   1e-5 of the plain version relative to each aggregate's sum of |v|;
   prolong-add bit for bit the plain version; each timed (warm and with
   L2 flushed) beside its bound (v and order read, rc written; x and agg
   read, out written, at the HBM rate), the plain version and the library
   call (index_add_; index_select and an add), which the port never
   calls.  Both kernels are also counted, and required to launch, on the
   AMG phases 7 and 9;
31. (run after phase 30) the neighbor search kernel
   (csrc/neighbor_search.cu) against the plain blocked search
   (ops/neighbors.py:search_blocked) on the same CUDA tensors, idx, mask,
   count and overflow exactly, with the plan's tile and with tiles that
   split every union, one launch each, and through build_neighbor_list:
   the 64^3 jittered Quintic lattice (K = 408, cap 40, subdiv 2), the 1M
   band list (K = 32, window 3072), K = 16 below the counts, 10% invalid
   particles, a clamped-axis slab, an 8^3 lattice with two cells a
   periodic axis and a 32^3 Quintic lattice in f64; first a probe that
   PyTorch still divides a CUDA tensor by a Python float as a product
   with the reciprocal (the kernel's rsq follows it); at 64^3 and 1M the
   kernel timed beside its bound (inputs read and outputs written once at
   the HBM rate), the plain version and the whole build, with each one's
   peak memory.  The kernel is also counted, and required to launch, on
   phases 4, 7 and 9;
32. (run after phase 31) the correction-tensor kernel
   (csrc/corrected_pre.cu) against compute_pre's plain chain
   (ops/corrected.py) on the same CUDA tensors, each launch synchronized
   before the next: the 64^3 cell's lattice (K = 408), the 1M cell's band
   lists (K = 32) and the ny = 1024 channel (K = 48, walls and padding
   rows), jittered 0.01 dx, each in f64 and f32 from the same positions;
   two launches a call, and compute_pre launches them; in f64 every field
   within 1e-10 of the plain version's largest value (vfrac's bitwise
   share logged); in f32 every field at most twice as far from the f64
   plain result as the plain f32 version; each timed (median of 30 warm
   calls) beside its bound (the pair arrays and idx read once, the fields
   written, at the HBM rate) and the plain version, with each one's peak
   memory.  The kernel is also counted, and required to launch twice a
   step, on phases 4, 7 and 9;
33. (run after phase 32) the AMG coarse-cycle kernel (csrc/amg_coarse.cu)
   at the cells' hierarchies below the fine level (_lattice_amg): the 1M
   cell's 113^2 / 37^2 / 12^2 in f32 and the cylinder's 56^2 / 18^2 in
   f64, two sweeps before and after as the cells smooth: the same bits on
   two calls (one launch each) and at clusters of 1, 2, 4 and 8 blocks,
   within 1e-5 (f32) and 1e-12 (f64) of the largest value from the plain
   version and from the roll chain (AMG._descend); timed (median of 30
   warm calls, and at each cluster size) beside its bound (the pack read,
   b read and the correction written once at the HBM rate), the plain
   version and the roll chain, with their host enqueue times.  The kernel
   is also counted on phases 7 (required to launch) and 9 (required not
   to: 64^3's only coarse level is the dense one).

Each phase's wall time is logged on a line of its own ("phase N (...): s"),
and the whole run's before the last lines.  The configurations' makers
and the measuring helpers (_tgv, _tgv1024, _tgv3, _channel, _edl_flow,
_transport_box, _pore3d, _qeq_setup, _median_ms, _bound, _spmv_bound, ...)
live in isph_tpu_torch/bench.py.

The last lines are the card's name and power limit from nvidia-smi, one
JSON line describing the kernels (time, launches on the main path, plain
and library times and bound of each, at the f32 (N,) shape of its phase;
ell_spmv and take also at 64^3, on the channel, on the PB Jacobian, on
the pore-scale deck, on the MLS matrices and fields of phase 22, on the
ILU factors and gathers of phase 24, the QEq matrix, types and
positions of phase 25, the sharded A_own and strip of phase 26 and the
extended slabs of phase 27, with their launches on phases 9, 11, 14-16,
18, 19, 21, 24, 25, 26 and 27; every kernel's launches in phase 28 as
launches_bench; comp_dots with its launches on phases 4, 5, 7, 9, 11,
14, 16, 19c, 24, 26 and 28 and phase 29's other shapes; the two AMG
transfer kernels at the 1M cell's level 0 with their launches on phases
7 and 9 and phase 30's other shapes; the neighbor search at 64^3 and 1M
with its launches on phases 4, 7 and 9; the correction tensors; the AMG
coarse cycle at the 1M hierarchy with its launches on phases 7 and 9 and
the cylinder's),
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
import sys
import tempfile
import time

import numpy as np
import torch

from isph_tpu_torch.bench import (  # noqa: F401  (configurations and measuring helpers)
    CYL, CYL_N, PORE_DECK, PORE_N, QEQ_K, QEQ_PARAMS, QEQ_SIDE, TRANSPORT_D0, WALLS_UMIN, _bound,
    _channel, _edl_flow, _geometry, _median_ms, _poisson_matrix, _pore3d, _pore3d_symmetric,
    _qeq_geometry, _qeq_setup, _slip_channel, _smi, _solve_times, _spmv_bound, _tgv, _tgv3,
    _tgv1024, _transport_box, _with_solver, qeq_lattice)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _tgv256(dev):
    return _tgv(dev, 256, "jacobi")


def _spmv_rel_err(yk, yp, diag, vals, idx, x):
    """max |kernel - plain| relative to the row's sum of |terms|: the two
    differ only in summation order (and FMA contraction)."""
    terms = (diag * x).abs() + (vals.abs() * x[..., idx].abs()).sum(-2)
    terms = torch.clamp_min(terms, torch.finfo(terms.dtype).tiny)  # empty padding rows
    return float(((yk - yp).abs() / terms).max()), float((yk - yp).abs().max())


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


# phase 29's shapes: (label, pairs, C, N); N = 65,536 is the main path's,
# 1,318,400 the sharded 1M slab's, 4 pairs pipelined CG's
COMP_DOT_SHAPES = (
    ("N=16384", 1, 1, 16_384), ("N=65536", 1, 1, 65_536), ("N=262144", 1, 1, 262_144),
    ("N=1048576", 1, 1, 1_048_576), ("N=1318400", 1, 1, 1_318_400), ("N=50001", 1, 1, 50_001),
    ("N=1", 1, 1, 1), ("C=2 N=65536", 1, 2, 65_536), ("C=3 N=65536", 1, 3, 65_536),
    ("4 pairs N=65536", 4, 1, 65_536), ("3 pairs N=1048576", 3, 1, 1_048_576))
COMP_DOT_MAIN = "N=65536"
# the shapes a CUDA graph captures: one block, a cluster, grids with a
# ticket, rows and a stack on a grid
COMP_DOT_GRAPHED = ("N=1", "N=16384", "N=65536", "N=1048576", "C=3 N=65536",
                    "3 pairs N=1048576")


def _dot_field(rng, shape, dev):
    """f32 values across 12 decades, both signs."""
    v = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6.0, 6.0, shape)
    return torch.as_tensor(v.astype(np.float32), device=dev)


def _library_dot(pairs):
    """One PyTorch call of the same sums (other bits: no compensation):
    torch.dot for a (N,) pair, torch.linalg.vecdot for (C, N) rows; None
    for a stack of pairs."""
    if len(pairs) > 1:
        return None
    a, b = pairs[0]
    return (lambda: torch.dot(a, b)) if a.ndim == 1 else (lambda: torch.linalg.vecdot(a, b))


def _bitwise_equal(got, ref):
    return got.shape == ref.shape and torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _comp_dot_graph(cd, label, pairs, rng, dev):
    """One comp_dots call captured in a CUDA graph and replayed three times,
    fresh inputs copied into the captured tensors before each replay: every
    replay gives the plain cascade's bits on its inputs, and the grid's
    ticket counters are back at 0 after each."""
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        cd.comp_dots(pairs)  # warm up on the side stream, as torch.cuda.graph asks
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cd.comp_dots(pairs)
    for k in range(3):
        for a, b in pairs:
            a.copy_(_dot_field(rng, tuple(a.shape), dev))
            b.copy_(_dot_field(rng, tuple(b.shape), dev))
        graph.replay()
        torch.cuda.synchronize()
        ref = cd.comp_dots_plain(pairs)
        if not _bitwise_equal(out, ref):
            raise RuntimeError(f"comp_dots: replay {k + 1} of the graph captured at {label} gives "
                               f"{out.tolist()}, the plain cascade {ref.tolist()}")
        live = int(cd._COUNTERS[dev.index].count_nonzero())
        if live:
            raise RuntimeError(f"comp_dots: {live} ticket counters not 0 after replay {k + 1} "
                               f"at {label}")
    del graph
    _log(f"comp_dot: {label}: a CUDA graph of one call replayed 3 times on fresh inputs, "
         f"bitwise equal to the plain cascade each time; counters at 0")


def phase_comp_dot(dev, flush):
    """Phase 29: the compensated dot kernel against the plain cascade on the
    same CUDA tensors, bit for bit (the f32 words of hi, lo and hi + lo
    compared, no tolerance), with one launch a call, at every shape of
    COMP_DOT_SHAPES; each timed beside its bound (the inputs read once at
    the HBM rate), the plain cascade and one library call (torch.dot /
    vecdot: a plain f32 sum, not the same bits), with the host's enqueue
    time of a call; an empty launch's time (torch.cuda._sleep(0)) beside
    them; a CUDA graph of one call at each COMP_DOT_GRAPHED shape replayed
    on fresh inputs."""
    from isph_tpu_torch.ops import comp_dot_cuda as cd

    rng = np.random.default_rng(29)
    empty, empty_host = _median_ms(lambda: torch.cuda._sleep(0))
    _log(f"comp_dot: an empty launch (torch.cuda._sleep(0)) {empty:.4f} ms; host enqueue "
         f"{empty_host:.1f} us")
    rows, graphed = {}, {}
    for label, npairs, C, n in COMP_DOT_SHAPES:
        shape = (n,) if C == 1 else (C, n)
        pairs = [(_dot_field(rng, shape, dev), _dot_field(rng, shape, dev))
                 for _ in range(npairs)]
        cd.comp_dots.launches = 0
        got = cd.comp_dots(pairs)
        launched = cd.comp_dots.launches
        ref = cd.comp_dots_plain(pairs)
        torch.cuda.synchronize()
        if not _bitwise_equal(got, ref):
            raise RuntimeError(f"comp_dots: the kernel's (hi, lo, hi + lo) {got.tolist()} are "
                               f"not the plain cascade's {ref.tolist()} at {label}")
        if launched != 1:
            raise RuntimeError(f"comp_dots: {launched} launches a call at {label}, not 1")
        err = float((got - ref).abs().max())
        tk, hk = _median_ms(lambda: cd.comp_dots(pairs))
        tkc, _ = _median_ms(lambda: cd.comp_dots(pairs), flush=flush)
        tp, _ = _median_ms(lambda: cd.comp_dots_plain(pairs), reps=10)
        lib = _library_dot(pairs)
        tl = None if lib is None else _median_ms(lib, reps=10)[0]
        nrows = npairs * C
        nbytes = 8 * nrows * n + 12 * nrows
        flops = nrows * (n + 8 * (cd.padded_length(n) - 1) + 1)
        bound, by = _bound(nbytes, flops)
        rows[label] = dict(ms=tk, plain_ms=tp, library_ms=tl, bound_ms=bound, bound_by=by,
                           err=err, host_us=hk)
        lib_s = "none (a stack)" if tl is None else f"{tl:.4f} ms"
        _log(f"comp_dot: {label}: bitwise equal to the plain cascade; {launched} launch "
             f"(plan {cd.comp_dot_plan(n, nrows)}); kernel={tk:.4f} ms, L2 flushed "
             f"{tkc:.4f} ms, bound={bound:.4f} ms ({nbytes / 1e6:.3f} MB, {by}), "
             f"share={bound / tk:.3f}, plain={tp:.4f} ms, library={lib_s}; host enqueue "
             f"{hk:.1f} us")
        if label in COMP_DOT_GRAPHED:
            graphed[label] = pairs
    for label, pairs in graphed.items():
        _comp_dot_graph(cd, label, pairs, rng, dev)
    return rows


def _lattice_aggs(side, cells, dim, dev):
    """Aggregates of a side^dim lattice (row-major, as the TGV decks lay
    it out) binned to a cells^dim grid."""
    c = torch.arange(side, device=dev) * cells // side
    grid = torch.meshgrid(*([c] * dim), indexing="ij")
    return sum(g * cells ** (dim - 1 - d) for d, g in enumerate(grid)).reshape(-1).to(
        torch.int32)


def _agg_transfers(dev):
    """(label, AMG transfer) at the cells' shapes: the 1M cell's level 0
    (12,769 aggregates of ~82 rows), its level 1 (1,369 of ~9, the grid
    parents) and 64^3's (64 of 4,096)."""
    from isph_tpu_torch.solvers import amg

    g113 = amg.CoarseGrid((113, 113), (2 * math.pi / 113,) * 2, (True, True), (0.0, 0.0))
    g37 = amg.CoarseGrid((37, 37), (2 * math.pi / 37,) * 2, (True, True), (0.0, 0.0))
    return ((AGG_MAIN, amg.make_transfer(_lattice_aggs(1024, 113, 2, dev), 113 * 113)),
            ("1M level 1", amg.make_transfer(amg._grid_parent(g113, g37, dev), 37 * 37)),
            ("64^3", amg.make_transfer(_lattice_aggs(64, 4, 3, dev), 64)))


# phase 30's main row, the 1M cell's level 0, and the f32 restrict's
# tolerance against the plain version (another summation order)
AGG_MAIN = "1M level 0"
AGG_RTOL = 1e-5


def phase_agg_transfer(dev, flush):
    """Phase 30: the AMG transfer kernels at the cells' shapes (module
    docstring)."""
    from isph_tpu_torch.ops import agg_transfer_cuda as at

    transfers = _agg_transfers(dev)
    shapes = (*((label, tr, 1) for label, tr in transfers),
              ("1M Galerkin C=10", transfers[0][1], 10))
    gen = torch.Generator(device=dev).manual_seed(30)
    rows = {}
    for label, tr, C in shapes:
        n, nc = tr.agg.shape[0], tr.nc
        v = torch.randn((C, n) if C > 1 else (n,), generator=gen, device=dev)
        at.agg_restrict.launches = 0
        got, again = tr.restrict(v), tr.restrict(v)
        torch.cuda.synchronize()
        if at.agg_restrict.launches != 2 or not _bitwise_equal(got, again):
            raise RuntimeError(f"agg_restrict: not one launch a call with the same bits at "
                               f"{label}")
        plain = at.agg_restrict_plain(v, tr.order, tr.start)
        aggl = tr.agg.long()
        scale = torch.zeros_like(got).index_add_(-1, aggl, v.abs())
        err = float(((got - plain).abs() / scale.clamp_min(1e-30)).max())
        if err > AGG_RTOL:
            raise RuntimeError(f"agg_restrict: {err:.3e} of an aggregate's sum of |v| from "
                               f"the plain version at {label}")
        item = v.element_size()
        nbytes = C * n * item + 4 * n + 4 * (nc + 1) + C * nc * item
        bound, by = _bound(nbytes)
        tk, hk = _median_ms(lambda: tr.restrict(v))
        tkc, _ = _median_ms(lambda: tr.restrict(v), flush=flush)
        tp, _ = _median_ms(lambda: at.agg_restrict_plain(v, tr.order, tr.start), reps=10)
        tl, _ = _median_ms(lambda: torch.zeros_like(got).index_add_(-1, aggl, v), reps=10)
        rows[f"restrict {label}"] = dict(ms=tk, plain_ms=tp, library_ms=tl, bound_ms=bound,
                                         bound_by=by, err=err, host_us=hk)
        _log(f"agg_transfer: restrict {label} (N={n}, nc={nc}, C={C}, group "
             f"{at.restrict_group(n, nc)}): same bits on two calls, {err:.2e} of the sum of "
             f"|v| from the plain version; kernel={tk:.4f} ms, L2 flushed {tkc:.4f} ms, "
             f"bound={bound:.4f} ms ({nbytes / 1e6:.3f} MB, {by}), share={bound / tk:.3f}, "
             f"plain={tp:.4f} ms, library (zeros + index_add_)={tl:.4f} ms; host enqueue "
             f"{hk:.1f} us")
        if C > 1:
            continue
        x = torch.randn(n, generator=gen, device=dev)
        xc = torch.randn(nc, generator=gen, device=dev)
        at.agg_prolong_add.launches = 0
        out = tr.prolong_add(x, xc)
        if at.agg_prolong_add.launches != 1 or not _bitwise_equal(
                out, at.agg_prolong_add_plain(x, xc, tr.agg)):
            raise RuntimeError(f"agg_prolong_add: not x + xc[agg] bit for bit at {label}")
        nbytes = 2 * n * item + 4 * n + nc * item
        bound, by = _bound(nbytes)
        tk, hk = _median_ms(lambda: tr.prolong_add(x, xc))
        tkc, _ = _median_ms(lambda: tr.prolong_add(x, xc), flush=flush)
        tp, _ = _median_ms(lambda: at.agg_prolong_add_plain(x, xc, tr.agg), reps=10)
        tl, _ = _median_ms(lambda: x + torch.index_select(xc, 0, aggl), reps=10)
        rows[f"prolong_add {label}"] = dict(ms=tk, plain_ms=tp, library_ms=tl, bound_ms=bound,
                                            bound_by=by, err=0.0, host_us=hk)
        _log(f"agg_transfer: prolong_add {label} (N={n}, nc={nc}): bit for bit x + xc[agg]; "
             f"kernel={tk:.4f} ms, L2 flushed {tkc:.4f} ms, bound={bound:.4f} ms "
             f"({nbytes / 1e6:.3f} MB, {by}), share={bound / tk:.3f}, plain={tp:.4f} ms, "
             f"library (index_select + add)={tl:.4f} ms; host enqueue {hk:.1f} us")
    return rows


def _lattice_amg(side, dim, dtype, dev, *, npre=2, npost=2, seed=0):
    """An AMG hierarchy whose levels >= 1 are those of a cell's: built on
    the 3^D-stencil operator of a periodic side^dim lattice (off-diagonals
    0.5-1.5 drawn from ``seed``, the diagonal -1.05 times their row sum),
    with aggregates of one lattice cell (coarsen 1), so that level 1 is a
    side^dim grid and the levels below it are make_coarse_grids's.  Sides
    113 (1M: 113^2 / 37^2 / 12^2), 56 (the cylinder: 56^2 / 18^2), 63
    (63^2 / 21^2 / 7^2) and 9 (9^3 / 3^3)."""
    from isph_tpu_torch.ops.ell import ELL
    from isph_tpu_torch.solvers import amg
    from isph_tpu_torch.state import Domain

    length = 2 * math.pi
    h = length / side
    grid = amg.CoarseGrid((side,) * dim, (h,) * dim, (True,) * dim, (0.0,) * dim)
    idx, mask = amg._grid_ell_structure(grid, dev)
    g = torch.Generator().manual_seed(seed)
    vals = (0.5 + torch.rand(idx.shape, generator=g, dtype=torch.float64)).to(dev, dtype)
    maskf = mask.to(dtype)
    vals = vals * maskf
    A = ELL(diag=-1.05 * vals.sum(dim=0), vals=vals, idx=idx, mask=maskf)
    cells = torch.arange(side, dtype=torch.float64, device=dev)
    x = torch.stack([c.reshape(-1) for c in torch.meshgrid(
        *([(cells + 0.5) * h] * dim), indexing="ij")]).to(dtype)
    domain = Domain(lo=(0.0,) * dim, hi=(length,) * dim, periodic=(True,) * dim)
    return amg.build_amg(A, x, domain, h * (1 - 1e-9), coarsen=1, npre=npre, npost=npost)


# phase 33's hierarchies (_lattice_amg sides), the main row first, and the
# kernel's tolerance against the plain version and the roll chain
AMG_COARSE_CASES = (("1M", 113, 2, torch.float32), ("cylinder", 56, 2, torch.float64))
AMG_COARSE_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def phase_amg_coarse(dev):
    """Phase 33: the AMG coarse-cycle kernel at the cells' hierarchies
    (module docstring)."""
    from isph_tpu_torch import _build
    from isph_tpu_torch.ops import amg_coarse_cuda as ac
    from isph_tpu_torch.ops.spmv_cuda import _SPMV_DTYPES, _stream

    rows = {}
    gen = torch.Generator(device=dev).manual_seed(33)
    for label, side, dim, dtype in AMG_COARSE_CASES:
        M = _lattice_amg(side, dim, dtype, dev)  # npre = npost = 2, the cells' smoothing
        pack, npre, npost = M.coarse_pack, M.npre, M.npost
        n1 = M.levels[1].n
        b = torch.randn(n1, generator=gen, device=dev, dtype=torch.float64).to(dtype)
        ac.amg_coarse_cycle.launches = 0
        got, again = (ac.amg_coarse_cycle(pack, b, npre, npost) for _ in range(2))
        torch.cuda.synchronize()
        if ac.amg_coarse_cycle.launches != 2 or not _bitwise_equal(got, again):
            raise RuntimeError(f"amg_coarse_cycle: not one launch a call with the same bits "
                               f"at {label}")
        plain = ac.amg_coarse_cycle_plain(pack, b, npre, npost)
        rolls = M._descend(1, b)
        err = max(float((got - ref).abs().max() / ref.abs().max()) for ref in (plain, rolls))
        if err > AMG_COARSE_RTOL[dtype]:
            raise RuntimeError(f"amg_coarse_cycle: {err:.3e} of the largest value from the "
                               f"plain version or the roll chain at {label}")
        item = b.element_size()
        nbytes = pack.vals.nbytes + pack.ints.nbytes + 2 * n1 * item
        bound, by = _bound(nbytes)
        tk, hk = _median_ms(lambda: ac.amg_coarse_cycle(pack, b, npre, npost))
        tp, hp = _median_ms(lambda: ac.amg_coarse_cycle_plain(pack, b, npre, npost), reps=10)
        tr, hr = _median_ms(lambda: M._descend(1, b), reps=10)
        lib = _build.load_library()
        layout = ac._c_layout(pack.layout)
        ws = torch.empty(pack.layout[6], dtype=dtype, device=dev)
        by_blocks = {}
        for blocks in (1, 2, 4, 8):
            def call(blocks=blocks):
                rc = lib.isph_amg_coarse_cycle(
                    _SPMV_DTYPES[dtype], pack.vals.data_ptr(), pack.ints.data_ptr(),
                    b.data_ptr(), ws.data_ptr(), layout, npre, npost, blocks, dev.index,
                    _stream(b))
                if rc != 0:
                    raise RuntimeError(f"amg_coarse_cycle with {blocks} blocks: cudaError {rc}")
            call()
            torch.cuda.synchronize()
            if not _bitwise_equal(ws[:n1], got):
                raise RuntimeError(f"amg_coarse_cycle: {blocks} blocks give other bits at "
                                   f"{label}")
            by_blocks[blocks] = _median_ms(call)[0]
        rows[label] = dict(ms=tk, plain_ms=tp, library_ms=None, bound_ms=bound, bound_by=by,
                           err=err, host_us=hk, rolls_ms=tr, rolls_host_us=hr,
                           plain_host_us=hp, blocks=ac.coarse_blocks(n1),
                           ms_by_blocks=by_blocks)
        _log(f"amg_coarse: {label} (levels {M.grid_shapes}, {dtype}, npre {npre} npost "
             f"{npost}, {ac.coarse_blocks(n1)} blocks): same bits on two calls and at 1-8 "
             f"blocks, {err:.2e} of the largest value from the plain version and the roll "
             f"chain; kernel={tk:.4f} ms (host enqueue {hk:.1f} us), bound={bound:.4f} ms "
             f"({nbytes / 1e6:.3f} MB, {by}), share={bound / tk:.3f}; by blocks "
             f"{ {k: round(v, 4) for k, v in by_blocks.items()} } ms; plain={tp:.4f} ms "
             f"(host {hp:.1f} us), roll chain={tr:.4f} ms (host {hr:.1f} us)")
    return rows


def _search_cases(dev):
    """(label, x, valid, domain, cutoff, K, cell capacity, subdiv, stream
    window) of phase 31: the benchmark cells' lists, then the paths the
    kernel takes besides them."""
    from isph_tpu_torch.config import KernelType
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.state import Domain

    rng = np.random.default_rng(31)

    def jitter(x, dx, frac):
        return x + torch.as_tensor(rng.uniform(-frac * dx, frac * dx, tuple(x.shape)),
                                   dtype=x.dtype, device=dev)

    def lattice(side, dim, dtype, frac=0.1):
        dx = 2 * math.pi / side
        g = np.stack(np.meshgrid(*[(np.arange(side) + 0.5) * dx] * dim, indexing="ij"), 0)
        x = jitter(torch.as_tensor(g.reshape(dim, -1), dtype=dtype, device=dev), dx, frac)
        return x, torch.ones(x.shape[1], dtype=torch.bool, device=dev), dx

    def box(dim, periodic=(True, True, True)):
        return Domain((0.0,) * dim, (2 * math.pi,) * dim, tuple(periodic[:dim]))

    sim, st = tgv.make_tgv(64, dim=3, kernel=KernelType.QUINTIC, max_neighbors=408,
                           dtype=torch.float32, device=dev)
    nb = sim.cfg.neighbor
    yield ("64^3 Quintic", jitter(st.x, 2 * math.pi / 64, 0.01), st.valid, sim.domain,
           sim.cfg.cut, nb.max_neighbors, nb.cell_capacity, nb.cell_subdiv, 0)
    del st
    sim, st = _tgv1024(dev)
    nb = sim.cfg.neighbor
    yield ("1M band", jitter(st.x, 2 * math.pi / 1024, 0.01), st.valid, sim.domain,
           sim.cfg.cut, nb.max_neighbors, nb.cell_capacity, nb.cell_subdiv, nb.stream_window)
    del st
    dx = 2 * math.pi / 256
    x, valid, _ = lattice(256, 2, torch.float32)
    yield "K = 16 below the counts", x, valid, box(2), 3 * dx, 16, 24, 1, 0
    valid = torch.as_tensor(rng.uniform(size=x.shape[1]) > 0.1, device=dev)
    yield "10% invalid", x, valid, box(2), 3 * dx, 32, 24, 1, 0
    xs = torch.stack([x[0] * 0.8 + 0.1, x[1]])
    yield ("clamped-axis slab", xs, torch.ones_like(valid), box(2, (False, True)), 3 * dx,
           48, 24, 1, 0)
    x, valid, dx = lattice(8, 3, torch.float32)
    yield "8^3, two cells a periodic axis", x, valid, box(3), 3 * dx, 128, 128, 1, 0
    x, valid, dx = lattice(32, 3, torch.float64, 0.01)
    yield "32^3 Quintic f64", x, valid, box(3), 4.5 * dx, 408, 40, 2, 0


def _division_probe(dev):
    """How PyTorch rounds a CUDA tensor divided by a Python float: the
    minimum image's r / L, against r times the reciprocal rounded in f32 and
    against the correctly rounded quotient."""
    L = 2 * math.pi
    gen = torch.Generator(device=dev).manual_seed(3)
    r = (torch.rand(1 << 24, generator=gen, device=dev) * 2 - 1) * L
    q = r / L
    inv = float(np.float32(1.0) / np.float32(L))
    by_inv = int((q != r * inv).sum())
    exact = int((q != (r.double() / float(np.float32(L))).float()).sum())
    _log(f"neighbor search: a CUDA f32 tensor / L (2 pi) differs from r * f32(1 / f32(L)) in "
         f"{by_inv} of {r.numel()} values, from the correctly rounded quotient in {exact}")
    return by_inv


def phase_neighbor_search(dev):
    """Phase 31: the neighbor search kernel against the plain blocked search
    on the same CUDA tensors (module docstring)."""
    from isph_tpu_torch.ops import neighbor_search_cuda as nsc
    from isph_tpu_torch.ops import neighbors as tnb

    if _division_probe(dev) != 0:
        raise RuntimeError("PyTorch no longer divides a CUDA tensor by a Python float as a "
                           "product with the reciprocal: the search kernel's rsq would differ")
    rows = {}
    for label, x, valid, dom, cut, K, cap, subdiv, window in _search_cases(dev):
        bins = tnb.bin_particles(x, valid, dom, cut, cap, subdiv)
        plain = tnb.search_blocked(bins, valid, dom, cut, K)
        n, Q = x.shape[1], len(bins.offsets)
        tile = nsc.search_plan(n, bins.ncells, Q, cap, x.shape[0], x.dtype)

        def overflow(t):
            ovf = torch.clamp_min(t[2].max() - K, 0) + bins.cell_overflow
            return int(ovf + tnb.band_check(t[0], window, 64)[0]) if window else int(ovf)

        # the plan's tile, then tiles that split every union
        for force in (None, max(32, tile // 8)):
            before = nsc.neighbor_search.launches
            got = tnb.search_kernel(bins, dom, cut, K, tile=force)
            torch.cuda.synchronize()
            if nsc.neighbor_search.launches != before + 1:
                raise RuntimeError(f"neighbor search: not one launch at {label}")
            same = [torch.equal(g, p) for g, p in zip(got, plain)]
            if not all(same) or overflow(got) != overflow(plain):
                raise RuntimeError(f"neighbor search: the kernel (tile {force or tile}) differs "
                                   f"from the plain version at {label}: idx/mask/count equal "
                                   f"{same}, overflow {overflow(got)} against "
                                   f"{overflow(plain)}")
            del got
        before = nsc.neighbor_search.launches
        nl = tnb.build_neighbor_list(x, valid, dom, cut, K, cap, cell_subdiv=subdiv,
                                     stream_window=window)
        if nsc.neighbor_search.launches != before + 1 or not torch.equal(nl.idx, plain[0]):
            raise RuntimeError(f"neighbor search: build_neighbor_list did not launch the "
                               f"kernel or differs at {label}")
        count = plain[2][valid]
        _log(f"neighbor search: {label} (N={n}, K={K}, cap {cap}, subdiv {subdiv}, {Q} cells "
             f"a neighborhood, {bins.ncells} cells, tile {tile}): idx, mask, "
             f"count and overflow ({overflow(plain)}; cells past capacity "
             f"{int(bins.cell_overflow)}) equal the plain version's, also in tiles of "
             f"{max(32, tile // 8)}; counts {int(count.min())}-{int(count.max())}, "
             f"{int((~valid).sum())} parked")
        if window or label.startswith("64^3"):
            item = x.element_size()
            nbytes = (x.numel() * item + bins.table.numel() * 4 + 4 * n
                      + 4 * (bins.ncells + 1) + K * n * 5 + 4 * n)
            bound, by = _bound(nbytes)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tk, hk = _median_ms(lambda: tnb.search_kernel(bins, dom, cut, K))
            peak_k = torch.cuda.max_memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            tp, _ = _median_ms(lambda: tnb.search_blocked(bins, valid, dom, cut, K), reps=3)
            peak_p = torch.cuda.max_memory_allocated() - base
            tb, _ = _median_ms(lambda: tnb.build_neighbor_list(
                x, valid, dom, cut, K, cap, cell_subdiv=subdiv, stream_window=window), reps=10)
            rows[label] = dict(ms=tk, plain_ms=tp, library_ms=None, bound_ms=bound,
                               bound_by=by, build_ms=tb, host_us=hk)
            _log(f"neighbor search: {label}: kernel={tk:.4f} ms, bound={bound:.4f} ms "
                 f"({nbytes / 1e6:.1f} MB, {by}), share={bound / tk:.4f}, plain={tp:.2f} ms; "
                 f"peak above the inputs: kernel {peak_k / 2**20:.1f} MiB, plain "
                 f"{peak_p / 2**20:.1f} MiB; build_neighbor_list {tb:.3f} ms; host enqueue "
                 f"{hk:.1f} us")
        del plain, nl, bins
        torch.cuda.empty_cache()
    return rows


def _not_twice_a_step(launches, nsteps=3):
    """True unless the correction-tensor kernel launched twice a step (a
    retried step launches again)."""
    n = launches["corrected_pre"]
    return n < 2 * nsteps or n % 2 != 0


def _pre_cases(dev):
    """(label, sim, f32 state) of phase 32: the benchmark cells' lattices
    and the channel, positions jittered 0.01 dx (fluid only in the
    channel)."""
    from isph_tpu_torch.config import KernelType
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.state import Kind

    rng = np.random.default_rng(32)

    def jitter(st, dx):
        move = (st.valid & ((st.kind & (Kind.SOLID | Kind.BOUNDARY)) == 0)).to(st.x.dtype)
        d = torch.as_tensor(rng.uniform(-0.01 * dx, 0.01 * dx, tuple(st.x.shape)),
                            dtype=st.x.dtype, device=dev)
        return st.replace(x=st.x + d * move[None, :])

    sim, st = tgv.make_tgv(64, dim=3, kernel=KernelType.QUINTIC, max_neighbors=408,
                           dtype=torch.float32, device=dev)
    yield "64^3 Quintic", sim, jitter(st, 2 * math.pi / 64)
    sim, st = _tgv1024(dev)
    yield "1M band", sim, jitter(st, 2 * math.pi / 1024)
    sim, st = _channel(dev)
    yield "channel", sim, jitter(st, 1.0 / 1024)


def _pre_plain(geom, kind):
    """compute_pre's plain chain on the card."""
    from isph_tpu_torch.ops import corrected as ops

    vfrac = ops.shepard_volume(geom)
    Gc = ops.gradient_correction(geom, vfrac)
    Lc = ops.laplacian_correction(geom, vfrac, Gc)
    normal, pnd = ops.interface_normal(geom, vfrac, kind, Gc)
    return vfrac, Gc, Lc, normal, pnd


PRE_FIELDS = ("vfrac", "Gc", "Lc", "normal", "pnd")


def _pre_gap(got, ref, name):
    """Largest difference over the field's largest magnitude (1 for the
    unit normals)."""
    scale = 1.0 if name == "normal" else float(ref.abs().max())
    return float((got.double() - ref.double()).abs().max()) / max(scale, 1e-300)


def phase_corrected_pre(dev):
    """Phase 32: the correction-tensor kernel against compute_pre's plain
    chain on the same CUDA tensors (module docstring)."""
    from isph_tpu_torch.ops import corrected_pre_cuda as cpc
    from isph_tpu_torch.physics import ns_projection

    def synced(v):  # between the launches, where the sharded step exchanges
        torch.cuda.synchronize()
        return v

    rows, worst = {}, 0.0
    for label, sim, st in _pre_cases(dev):
        ref = None
        for dtype in (torch.float64, torch.float32):
            s = st.replace(x=st.x.to(dtype))
            geom = sim.geometry(s, sim.neighbors(s))
            K, n = geom.r.shape
            tag = f"{label} {'f64' if dtype == torch.float64 else 'f32'}"
            before = cpc.corrected_pre.launches
            got = cpc.corrected_pre(geom, s.kind, synced)
            torch.cuda.synchronize()
            if cpc.corrected_pre.launches != before + 2:
                raise RuntimeError(f"corrected_pre: not two launches at {tag}")
            pre = ns_projection.compute_pre(s, geom, sim.cfg)
            if cpc.corrected_pre.launches != before + 4 or not all(
                    torch.equal(getattr(pre, f), g) for f, g in zip(PRE_FIELDS, got)):
                raise RuntimeError(f"corrected_pre: compute_pre did not launch the kernel or "
                                   f"differs from it at {tag}")
            plain = _pre_plain(geom, s.kind)
            if dtype == torch.float64:
                ref = plain
                gaps = {f: _pre_gap(g, p, f) for g, p, f in zip(got, plain, PRE_FIELDS)}
                same = float((got[0] == plain[0]).double().mean())
                worst = max(worst, max(gaps.values()))
                _log(f"corrected_pre: {tag} (N={n}, K={K}): gaps to the plain version "
                     f"{ {f: f'{v:.2e}' for f, v in gaps.items()} }; vfrac bitwise in "
                     f"{same:.4f} of the rows")
                if max(gaps.values()) > 1e-10:
                    raise RuntimeError(f"corrected_pre: f64 kernel off the plain version at "
                                       f"{tag}: {gaps}")
            else:
                gk = {f: _pre_gap(g, r, f) for g, r, f in zip(got, ref, PRE_FIELDS)}
                gp = {f: _pre_gap(p, r, f) for p, r, f in zip(plain, ref, PRE_FIELDS)}
                _log(f"corrected_pre: {tag} (N={n}, K={K}): gaps to f64, kernel "
                     f"{ {f: f'{v:.2e}' for f, v in gk.items()} }, plain "
                     f"{ {f: f'{v:.2e}' for f, v in gp.items()} }")
                if any(gk[f] > 2.0 * gp[f] for f in PRE_FIELDS):
                    raise RuntimeError(f"corrected_pre: f32 kernel more than twice as far from "
                                       f"f64 as the plain f32 version at {tag}: {gk} {gp}")
            del got, pre, plain
            item, dim, dl = geom.r.element_size(), geom.dim, geom.dim * (geom.dim + 1) // 2
            nbytes = K * n * ((dim + 4) * item + 4) + n * (item + 4) + n * item * (
                2 + dim * dim + dl + dim)
            bound, by = _bound(nbytes)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tk, hk = _median_ms(lambda: cpc.corrected_pre(geom, s.kind))
            peak_k = torch.cuda.max_memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            tp, _ = _median_ms(lambda: _pre_plain(geom, s.kind), reps=3)
            peak_p = torch.cuda.max_memory_allocated() - base
            rows[tag] = dict(ms=tk, plain_ms=tp, library_ms=None, bound_ms=bound, bound_by=by,
                             host_us=hk)
            _log(f"corrected_pre: {tag}: kernel={tk:.4f} ms, bound={bound:.4f} ms "
                 f"({nbytes / 1e6:.1f} MB, {by}), share={bound / tk:.4f}, plain={tp:.2f} ms; "
                 f"peak above the inputs: kernel {peak_k / 2**20:.1f} MiB, plain "
                 f"{peak_p / 2**20:.1f} MiB; host enqueue {hk:.1f} us")
            del geom, s
            torch.cuda.empty_cache()
        del sim, st, ref
        torch.cuda.empty_cache()
    return dict(rows=rows, err=worst)


def _run_steps(tag, sim, state, wrappers, cap_check=True, nsteps=3, each=None, step=None):
    """``nsteps`` steps through Simulation.run, one call per step (the same
    steps as run(state, nsteps)), or through ``step(state)`` where given,
    the wrappers' launch counters set to 0 just before and read just after.
    Fails on a neighbor overflow, a non-finite status and, with
    ``cap_check``, a Poisson solve at the iteration cap.  ``each(k, state,
    aux)`` sees every step's result."""
    if step is None:
        step = lambda s: sim.run(s, 1)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    for k in range(nsteps):
        state, aux = step(state)
        _log(f"{tag}: step {k + 1}: helmholtz_iters={int(aux.helmholtz_iters)} "
             f"poisson_iters={int(aux.poisson_iters)} "
             f"poisson_relres={float(aux.poisson_relres):.3e} "
             f"overflow={int(aux.neighbor_overflow)}")
        if int(aux.neighbor_overflow) != 0:
            raise RuntimeError(f"neighbor overflow on the {tag} path")
        if cap_check and int(aux.poisson_iters) >= sim.cfg.solver.max_iters:
            raise RuntimeError(f"Poisson GMRES reached the {sim.cfg.solver.max_iters} cap")
        if each is not None:
            each(k, state, aux)
    launches = {w.__name__: w.launches for w in wrappers}
    _log(f"{tag}: launches {launches}; peak memory "
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


# phase 4's (Helmholtz, Poisson) iterations and vmax bits (float.hex) of
# each step on an NVIDIA H100 80GB HBM3, the same in two runs (PERF.md): the
# compensated dot kernel keeps the eager cascade's bits (c62ac79 gave
# these counts before it); the correction-tensor kernel sums each particle's
# slots in its own order, so its f32 Gc and Lc, and these, are its own
MAIN_PARENT = ((10, 500, "0x1.9688e00000000p-4"), (10, 185, "0x1.93915c0000000p-4"),
               (10, 300, "0x1.909e1c0000000p-4"))


def phase_main_path(dev):
    """Three 256^2 f32 Jacobi projection steps through Simulation.run; the
    iterations and vmax of each step are MAIN_PARENT's, bit for bit."""
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.ops import comp_dot_cuda as cd
    from isph_tpu_torch.ops import corrected_pre_cuda as cpc
    from isph_tpu_torch.ops import neighbor_search_cuda as nsc
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _tgv256(dev)
    iters, record = [], []

    def each(k, st, aux):
        iters.append((int(aux.helmholtz_iters), int(aux.poisson_iters)))
        record.append((*iters[-1], float(aux.status.vmax).hex()))

    state, aux, launches = _run_steps("main", sim, state, (sc.ell_spmv, sc.take, cd.comp_dots,
                                                           nsc.neighbor_search,
                                                           cpc.corrected_pre),
                                      cap_check=False, each=each)
    if min(launches.values()) <= 0 or _not_twice_a_step(launches):
        raise RuntimeError(f"a kernel of the main path never launched, or the correction "
                           f"tensors' not twice a step: {launches}")
    _log(f"main: (helmholtz, poisson, vmax) a step {record}; the parent's {MAIN_PARENT}")
    if tuple(record) != MAIN_PARENT:
        raise RuntimeError(f"the main path's counts or vmax bits {record} are not the "
                           f"parent's {MAIN_PARENT}")
    _check_vortex("main", aux, (2 * math.pi) ** 2)
    err = tgv.compute_error(state.replace(vstar=state.v), float(aux.status.time))
    _log(f"main: L2 error vs exact: pressure={float(err.pressure_l2):.4e} "
         f"velocity={float(err.velocity_l2):.4e}")
    return launches, sim, state, float(aux.status.time), iters


def _record_iters(out):
    """An ``each`` for _run_steps that appends (Helmholtz, Poisson)
    iterations of every step to ``out``."""
    def each(k, state, aux):
        out.append((int(aux.helmholtz_iters), int(aux.poisson_iters)))

    return each


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
    from isph_tpu_torch.ops import agg_transfer_cuda as at
    from isph_tpu_torch.ops import amg_coarse_cuda as acc
    from isph_tpu_torch.ops import comp_dot_cuda as cd
    from isph_tpu_torch.ops import corrected_pre_cuda as cpc
    from isph_tpu_torch.ops import neighbor_search_cuda as nsc
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _tgv1024(dev)
    iters = []
    state, aux, launches = _run_steps(
        "large", sim, state,
        (sc.ell_spmv, sc.take, sc.ell_spmv_band, sc.take_band, cd.comp_dots, at.agg_restrict,
         at.agg_prolong_add, nsc.neighbor_search, cpc.corrected_pre, acc.amg_coarse_cycle),
        each=_record_iters(iters))
    if min(launches["ell_spmv_band"], launches["take_band"], launches["comp_dots"],
           launches["agg_restrict"], launches["agg_prolong_add"],
           launches["neighbor_search"], launches["amg_coarse_cycle"]) <= 0 or (
               _not_twice_a_step(launches)):
        raise RuntimeError(f"a band kernel, comp_dots, an AMG transfer kernel, the neighbor "
                           f"search or the AMG coarse cycle never launched on the large-N "
                           f"path, or the correction tensors' not twice a step: {launches}")
    _check_vortex("large", aux, (2 * math.pi) ** 2)
    return launches, dict(ke=float(aux.status.kinetic_energy), vmax=float(aux.status.vmax),
                          nfluid=float(aux.status.nfluid), iters=iters)


def _dots_launched(tag, fn):
    """``fn()`` with comp_dots' counter set to 0 just before and read just
    after; fails if the f32 solves in it never launched the kernel.
    Returns (fn's result, the launches)."""
    from isph_tpu_torch.ops import comp_dot_cuda as cd

    torch.cuda.synchronize()
    cd.comp_dots.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launched = cd.comp_dots.launches
    _log(f"{tag}: comp_dots launches {launched}")
    if launched <= 0:
        raise RuntimeError(f"comp_dots never launched on the {tag} path")
    return out, launched


def phase_golden(dev):
    """tests/test_f32.py's TGV-16 harness through the port on the card;
    returns comp_dots' launches in its three steps."""
    from isph_tpu_torch.models import tgv

    gp, gv, nsteps = 8.466849370245e-04, 7.500246669496e-04, 3
    sim, state = tgv.make_tgv(16, dtype=torch.float32, device=dev)
    (state, info), launched = _dots_launched("golden", lambda: _golden_steps(sim, state, nsteps))
    err = tgv.compute_error(state, sim.cfg.dt * nsteps)
    pe = float(err.pressure_l2) / gp - 1.0
    ve = float(err.velocity_l2) / gv - 1.0
    relres = float(info.poisson.relres)
    _log(f"golden: TGV-16 f32 pressure_l2={float(err.pressure_l2):.6e} ({pe:+.4%}) "
         f"velocity_l2={float(err.velocity_l2):.6e} ({ve:+.4%}) relres={relres:.2e}")
    if abs(pe) > 2e-2 or abs(ve) > 2e-2 or not relres < 5e-5:
        raise RuntimeError("TGV-16 f32 golden off by more than 2%")
    return launched


def _golden_steps(sim, state, nsteps):
    """The golden harness's steps: errors are read before the last
    advance_time."""
    from isph_tpu_torch.physics import ns_projection as ns

    for step in range(1, nsteps + 1):
        nbrs = sim.neighbors(state)
        geom = sim.geometry(state, nbrs)
        pre = sim.precompute(state, geom)
        state, info = ns.navier_stokes_step(state, geom, pre, sim.cfg)
        if step < nsteps:
            state = ns.advance_time(state, geom, pre, sim.cfg, sim.domain)
    return state, info


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
    from isph_tpu_torch.ops import agg_transfer_cuda as at
    from isph_tpu_torch.ops import amg_coarse_cuda as acc
    from isph_tpu_torch.ops import comp_dot_cuda as cd
    from isph_tpu_torch.ops import corrected_pre_cuda as cpc
    from isph_tpu_torch.ops import neighbor_search_cuda as nsc
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
    state, aux, launches = _run_steps("3d path", sim, state,
                                      (sc.ell_spmv, sc.take, cd.comp_dots, at.agg_restrict,
                                       at.agg_prolong_add, nsc.neighbor_search,
                                       cpc.corrected_pre, acc.amg_coarse_cycle))
    coarse = launches.pop("amg_coarse_cycle")  # 4^3 is the only coarse level: dense
    if min(launches.values()) <= 0 or _not_twice_a_step(launches) or coarse != 0:
        raise RuntimeError(f"a kernel of the 3-D path never launched, the correction "
                           f"tensors' not twice a step, or the AMG coarse cycle launched "
                           f"({coarse}) on a hierarchy without a stencil level: {launches}")
    launches["amg_coarse_cycle"] = coarse
    _check_vortex("3d path", aux, (2 * math.pi) ** 3)
    _, aux_a = sim.step(state)
    _, aux_j = _with_solver(sim, precond="jacobi").step(state)
    _log(f"3d path: step 4's Poisson solve with Jacobi: {int(aux_j.poisson_iters)} "
         f"iterations (relres {float(aux_j.poisson_relres):.3e}) against AMG's "
         f"{int(aux_a.poisson_iters)} (relres {float(aux_a.poisson_relres):.3e})")
    return launches


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
    from isph_tpu_torch.ops import comp_dot_cuda as cd
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = _channel(dev)
    solid = state.is_solid & state.valid
    x0 = state.x[:, solid].clone()
    _log(f"channel: N={state.n} ({int(state.valid.sum())} particles, {int(solid.sum())} "
         f"wall), walls {sim.cfg.ns.boundary.value}, shift {sim.cfg.shift.shift}, "
         f"dt {sim.cfg.dt:.6g}, precond {sim.cfg.solver.precond}")
    state, aux, launches = _run_steps("channel", sim, state,
                                      (sc.ell_spmv, sc.take, cd.comp_dots))
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
    particles).  With ``converge`` a Newton that does not converge fails."""
    from isph_tpu_torch.models import edl
    from isph_tpu_torch.ops import corrected as ops
    from isph_tpu_torch.physics import electrokinetics as ek

    sim, state = edl.make_channel_edl(n, device=dev)
    _, geom, pre = _geometry(sim, state)
    cfg = sim.cfg
    mirror = ops.morris_holmes_mirror(geom, state.kind, pre.pnd, pre.vfrac, cfg.cut, cfg.h,
                                      safe=0.0)
    psi, _, info = ek.solve_poisson_boltzmann(state, geom, pre, cfg, mirror=mirror)
    err, norm = edl.psi_error(state, psi)
    if converge and not bool(info.converged):
        raise RuntimeError(f"channel-EDL n={n}: Newton did not converge "
                           f"(NormF {float(info.norm_f):.3e})")
    return float(err / norm), info, int(state.valid.sum())


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

    rel, info, npart = _channel_edl_potential(dev, 32)
    _log(f"edl golden: channel-EDL n=32 ({npart} particles): relative psi error {rel:.6e} "
         f"(table 4.210116e-02, {rel / 4.210116123449621e-02 - 1.0:+.3%}); Newton "
         f"{int(info.iters)}, NormF {float(info.norm_f):.3e}")
    if not abs(rel / 4.210116123449621e-02 - 1.0) < 0.05:
        raise RuntimeError("channel-EDL n=32 off the table by 5% or more")
    for n in (256, 512):
        rel, info, npart = _channel_edl_potential(dev, n, converge=n == 256)
        _log(f"edl golden: channel-EDL n={n} ({npart} particles): relative psi error "
             f"{rel:.6e} (JAX f64 at n=128: {EDL_POTENTIAL_REL_ERR_JAX_128:.6e}, at n=256: "
             f"{EDL_POTENTIAL_REL_ERR_JAX_256:.6e}); Newton {int(info.iters)} iterations, "
             f"{int(info.linear_iters)} GMRES, NormF {float(info.norm_f):.3e}")
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


def phase_edl_path(dev):
    """Three f64 steps of the n = 512 electroosmotic channel through
    Simulation.run; the PB Newton solve of its first step held to NormF <=
    tol_f; then one f32 step.  (The deck's transverse velocities grow from
    step to step in both packages; from the fourth step on the reference's
    Newton stalls at this size: PERF.md, section 6.)"""
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.physics import electrokinetics as ek

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
    _, geom, pre = _geometry(sim, state0)
    _, _, info = ek.solve_poisson_boltzmann(state0, geom, pre, sim.cfg)
    nf = float(info.norm_f)
    _log(f"edl path: step 1's PB Newton {int(info.iters)} iterations, "
         f"{int(info.linear_iters)} GMRES, NormF {nf:.3e} (tol_f {sim.cfg.newton.tol_f:.1e})")
    if not (bool(info.converged) and nf <= sim.cfg.newton.tol_f):
        raise RuntimeError(f"PB Newton did not converge: NormF {nf:.3e} after "
                           f"{int(info.iters)} iterations")
    del state, state0, geom, pre
    torch.cuda.empty_cache()

    sim32, state32 = _edl_flow(dev, torch.float32)
    (_, aux32), launches["comp_dots_f32"] = _dots_launched(
        "edl path f32", lambda: sim32.run(state32, 1))
    _log(f"edl path f32: one step: helmholtz_iters={int(aux32.helmholtz_iters)} "
         f"poisson_iters={int(aux32.poisson_iters)} "
         f"poisson_relres={float(aux32.poisson_relres):.3e}")
    return launches


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
    each step used, overflow, Helmholtz iterations and relres, and the
    state it returned): run_adaptive keeps its dt sequence and intermediate
    states to itself."""

    def __enter__(self):
        from isph_tpu_torch.models import driver

        self.rows, self._cls = [], driver.Simulation
        self._orig = orig = driver.Simulation.step
        rows = self.rows

        def step(sim, state):
            out = orig(sim, state)
            a = out[1]
            rows.append(dict(dt=sim.cfg.dt, overflow=int(a.neighbor_overflow),
                             h_iters=int(a.helmholtz_iters),
                             h_relres=float(a.helmholtz_relres), p_iters=int(a.poisson_iters),
                             state=out[0]))
            return out

        driver.Simulation.step = step
        return self

    def __exit__(self, *exc):
        self._cls.step = self._orig


def phase_walls(dev, tgv_sim, tgv_state, tgv_t):
    """Phase 16, walls and entry points, on the ny = 1024 channel.  Every
    check runs; the phase fails at its end naming each check that did not
    hold."""
    from isph_tpu_torch.config import BoundaryCond
    from isph_tpu_torch.io import checkpoint, dump
    from isph_tpu_torch.models import error, tgv
    from isph_tpu_torch.ops import comp_dot_cuda as cd
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
    for w in (sc.ell_spmv, sc.take, cd.comp_dots):
        w.launches = 0
    with _StepRecorder() as rec:
        state3, aux, dt = sim.run_adaptive(state, 3, cfl=0.25, dx=dx, umin=WALLS_UMIN)
    launches = {w.__name__: w.launches for w in (sc.ell_spmv, sc.take, cd.comp_dots)}
    peak = torch.cuda.max_memory_allocated() / 2**20
    for k, r in enumerate(rec.rows):
        _log(f"walls (b): step {k + 1}: dt {r['dt']:.6g} (dt nu/dx^2 "
             f"{r['dt'] * 0.1 / dx**2:.1f}) block GMRES {r['h_iters']} "
             f"iterations relres {r['h_relres']:.3e} (converged: {r['h_relres'] <= tol}, tol "
             f"{tol:.3e}), poisson_iters {r['p_iters']}, overflow {r['overflow']}")
    _log(f"walls (b): dt sequence {[r['dt'] for r in rec.rows]}, last {dt:.6g}; "
         f"launches {launches} "
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
        state, aux = sim.step(state)
        ovf = int(aux.neighbor_overflow)
        finite = all(bool(torch.isfinite(t).all()) for t in (state.x, state.v, state.p))
        vmax = float(state.v[:, fluid].abs().max()) if finite else float("nan")
        _log(f"pore3d record {kw or 'SI'}: step {k + 1}: helmholtz_iters="
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
    sim, state = _pore3d_symmetric(dev)
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
    f, kappa, normal = mp.csf_force(st1, geom, pre, cfg, ignore_mask=band)
    raw = float(grad[:, band].abs().max())
    in_band = max(float(f[:, band].abs().max()), float(kappa[band].abs().max()))
    _log(f"pore3d: ignore band holds {int(band.sum())} particles; the unmasked color "
         f"gradient there reaches {raw:.4e}, the CSF force and curvature there "
         f"{in_band:.1e}; outside, max |f| {float(f.abs().max()):.4e}")
    if not (raw > 0.0 and in_band == 0.0):
        raise RuntimeError("the color gradient is not zeroed inside the ignore band")
    torch.set_num_threads(os.cpu_count() or 1)
    f_c, kappa_c, normal_c = mp.csf_force(_to_cpu(st1), _to_cpu(geom), _to_cpu(pre), cfg,
                                          ignore_mask=band.cpu())
    errs = [_rel(a.cpu(), b) for a, b in ((f, f_c), (kappa, kappa_c), (normal, normal_c))]
    _log(f"pore3d: csf_force on the card against the CPU on the same step-1 state and "
         f"geometry: f {errs[0]:.3e}, kappa {errs[1]:.3e}, normal {errs[2]:.3e} relative "
         f"(bar 1e-12)")
    if not max(errs) <= 1e-12:
        raise RuntimeError("csf_force on the card is off the CPU's by more than 1e-12")
    del geom, pre, grad, f, kappa, normal, f_c, kappa_c, normal_c
    torch.cuda.empty_cache()
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


# the JAX package's f64 TGV-32 steps with the random stress (kbt 0.01,
# seed 7; make_tgv's defaults, the AMG cache on) on the CPU: (Poisson
# iterations, Helmholtz iterations, kinetic energy, vmax) after steps 1-3
RS_KBT, RS_SEED = 0.01, 7
RS_JAX = ((35, 30, 0.4535154917531848, 0.4208780812962685),
          (35, 30, 0.5171041262920552, 0.3981036669602701),
          (35, 30, 0.5607621128679595, 0.4707916561620587))
RS_DRAWS = ((2, 2, 65536), (3, 3, 703_040))  # TGV-256^2's draw; the pore deck's N (phase 18)


def _ulps(a, b):
    """Largest distance of two float tensors in units in the last place."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int64

    def ordered(x):
        i = x.contiguous().view(it).long()
        return torch.where(i < 0, torch.iinfo(it).min - i, i)

    return int((ordered(a) - ordered(b)).abs().max())


def _event_ms(fn, reps=5):
    """Median ms of ``fn()`` between two CUDA events, after one warm call."""
    return statistics.median(_solve_times(fn, reps))


def _threefry_on_card(dev):
    """Phase 19c (noise): JAX's threefry stream on the card against the
    CPU's, for the TGV-256^2 draw and a 3-D draw of the pore deck's size:
    the 32- and 64-bit words bitwise, the normals within 2 ulp in f32 and
    f64.  Returns the f32 TGV-256^2 draw's ms on the card (CUDA events)."""
    from isph_tpu_torch.utils import threefry

    key = threefry.fold_in(threefry.prng_key(RS_SEED), 12)
    ms = {}
    for shape in RS_DRAWS:
        words = all(torch.equal(threefry.random_bits(key, w, shape, dev).cpu(),
                                threefry.random_bits(key, w, shape, "cpu")) for w in (32, 64))
        ulps = {str(dt)[6:]: _ulps(threefry.normal(key, shape, dt, dev).cpu(),
                                   threefry.normal(key, shape, dt, "cpu"))
                for dt in (torch.float32, torch.float64)}
        for dt in (torch.float32, torch.float64):
            ms[(shape, dt)] = _event_ms(lambda: threefry.normal(key, shape, dt, dev))
        _log(f"random stress: threefry {shape}: card words equal the CPU's bitwise {words}; "
             f"normals within {ulps} ulp of the CPU's; draw "
             f"{ms[(shape, torch.float32)]:.3f} ms f32, {ms[(shape, torch.float64)]:.3f} ms "
             f"f64 (CUDA events, median of 5)")
        if not words or max(ulps.values()) > 2:
            raise RuntimeError(f"the card's threefry draw departs from the CPU's: {shape}")
    return ms[(RS_DRAWS[0], torch.float32)]


def _random_stress_against_jax(dev):
    """Phase 19c (steps): three f64 TGV-32 steps with the random stress on
    the card against the JAX package's CPU values (RS_JAX): Poisson and
    Helmholtz counts equal, KE and vmax within 1e-9 relative."""
    from isph_tpu_torch.config import RandomStressConfig
    from isph_tpu_torch.models import tgv

    sim, st = tgv.make_tgv(32, device=dev)
    sim = dataclasses.replace(sim, cfg=sim.cfg.replace(
        rs=RandomStressConfig(enabled=True, kbt=RS_KBT, seed=RS_SEED)))
    st = sim.prepare(st)
    for k, (jp, jh, jke, jv) in enumerate(RS_JAX):
        st, aux = sim.step(st)
        p, h = int(aux.poisson_iters), int(aux.helmholtz_iters)
        ke, vmax = float(aux.status.kinetic_energy), float(aux.status.vmax)
        d_ke, d_v = abs(ke / jke - 1.0), abs(vmax / jv - 1.0)
        _log(f"random stress: TGV-32 f64 step {k + 1} (seed {RS_SEED}, kbt {RS_KBT}): "
             f"(poisson, helmholtz) ({p}, {h}), JAX ({jp}, {jh}); KE {ke!r} (rel {d_ke:.2e}), "
             f"vmax {vmax!r} (rel {d_v:.2e})")
        if (p, h) != (jp, jh) or max(d_ke, d_v) > 1e-9:
            raise RuntimeError(f"the card's random-stress step {k + 1} departs from JAX's")


def phase_random_stress(dev, tgv_sim, tgv_state):
    """Phase 19c: the random stress for one step on phase 4's TGV-256^2 f32
    state: the tensor symmetric and traceless, the force linear in
    sqrt(kBT), the noise a function of (seed, step) alone; JAX's threefry
    draw on the card against the CPU's, and three f64 TGV-32 steps against
    JAX's values.  Returns comp_dots' launches in the f32 step."""
    from isph_tpu_torch.config import RandomStressConfig
    from isph_tpu_torch.physics import fluctuation as fl

    draw_ms = _threefry_on_card(dev)
    _random_stress_against_jax(dev)

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
    (out, aux), launched = _dots_launched("random stress", lambda: sim.run(tgv_state, 1))
    base, _ = tgv_sim.run(tgv_state, 1)
    dv = float((out.v - base.v).abs().max())
    _log(f"random stress: TGV-256^2 f32 step {step}, seed {seed}: noise std "
         f"{float(noise.std()):.4f}; same (seed, step) bitwise {same}, another step differs "
         f"{other}; S symmetric to {sym:.1e}, trace {trace:.1e} of max |S|; "
         f"f(kbt 4) - f0 against 2 (f(kbt 1) - f0): {lin:.3e} relative; one step with rs "
         f"(kbt 1e-6): "
         f"poisson_iters {int(aux.poisson_iters)}, max |v - v without rs| {dv:.4e}; its "
         f"(2, 2, 65536) f32 draw {draw_ms:.3f} ms")
    if not (same and other and sym == 0.0 and trace <= 1e-6 and lin <= 1e-6):
        raise RuntimeError("the random stress failed a check")
    if not (bool(torch.isfinite(out.v).all()) and dv > 0.0):
        raise RuntimeError("the random-stress step is not finite or changed nothing")
    return launched

# the JAX package's f64 vmax after steps 1-3 at n = 256 (on the CPU; both
# Poisson solves stop at their 750-iteration cap, so the fields agree to
# about the relres, ~1e-7)
CYL_JAX_VMAX = (1.1780202282725939e-3, 2.4129037642273026e-3, 3.6963705518801527e-3)
CYL_CD = 1.8561873826547262  # tests/test_decks.py's n = 32, 20-step drag golden


def _ale_poisson_matrix(sim, state, geom=None):
    """The ALE Poisson matrix of a state as ale_navier_stokes_step
    assembles it: -dt times the MLS Laplacian rows of the fluid (filter
    F,F; mass matrix F,ALL), solid rows diag -1 and zeroed; on ``geom``
    where given (an extended slab's), else on the state's own neighbor
    list.  Returns (the matrix, the pair geometry)."""
    from isph_tpu_torch.ops import mls
    from isph_tpu_torch.ops.corrected import PairFilter
    from isph_tpu_torch.state import Kind

    if geom is None:
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
    state, aux = sim.run(state, 20)
    launches = {w.__name__: w.launches for w in (sc.ell_spmv, sc.take)}
    _, geom, pre = _geometry(sim, state)
    cd, cl = (float(t) for t in drag_lift(state, geom, pre, sim.cfg, state.is_solid))
    finite = bool(torch.isfinite(state.v).all() & torch.isfinite(state.p).all())
    relres = float(aux.poisson_relres)
    _log(f"cylinder golden: n=32 N={state.n}, 20 steps, launches {launches}; "
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
    each Poisson relres < 1e-6 and vmax within 1e-5 of JAX's; the
    iterations, the peak memory and a fourth step; then one step at
    n = 512, logged.  Returns the launches, the step-3 (simulation, state)
    for phase 22 and the iterations for phase 27."""
    from isph_tpu_torch.models import decks
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = decks.build_deck(CYL, n=CYL_N, device=dev)
    solid = state.is_solid & state.valid
    sc_ = sim.cfg.solver
    iters = []
    _log(f"cylinder: {CYL} n={CYL_N} N={state.n} ({int(solid.sum())} solid), "
         f"K={sim.cfg.neighbor.max_neighbors}, dt {sim.cfg.dt:.6g}, f64; Jacobi GMRES"
         f"({sc_.restart}) x {sc_.max_restarts} restarts, tol {sc_.tol:g} (the registry's "
         f"precond {sc_.precond!r}, which the JAX package's ALE solves run)")
    bad = []

    def each(k, st, aux):
        vmax = float(aux.status.vmax)
        rel = vmax / CYL_JAX_VMAX[k] - 1.0
        _log(f"cylinder: step {k + 1}: vmax {vmax:.17g} (JAX {CYL_JAX_VMAX[k]:.17g}, {rel:+.2e}), "
             f"helmholtz relres {float(aux.helmholtz_relres):.3e}")
        if not (float(aux.poisson_relres) < 1e-6 and abs(rel) < 1e-5):
            bad.append(k + 1)
        iters.append((int(aux.helmholtz_iters), int(aux.poisson_iters)))

    state, aux, launches = _run_steps("cylinder", sim, state, (sc.ell_spmv, sc.take),
                                      cap_check=False, each=each)
    if bad:
        raise RuntimeError(f"cylinder steps {bad}: Poisson relres >= 1e-6 or vmax off JAX's")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the cylinder path never launched: {launches}")
    st4, aux4 = sim.run(state, 1)
    _log(f"cylinder: step 4: poisson_iters {int(aux4.poisson_iters)} relres "
         f"{float(aux4.poisson_relres):.3e}, overflow {int(aux4.neighbor_overflow)}, finite "
         f"{bool(torch.isfinite(st4.v).all())}")
    if int(aux4.neighbor_overflow) != 0 or not bool(torch.isfinite(st4.v).all()):
        raise RuntimeError("the cylinder's step 4 overflowed or is not finite")
    del st4

    sim5, st5 = decks.build_deck(CYL, n=2 * CYL_N, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st5, aux5 = sim5.run(st5, 1)
    _log(f"cylinder n={2 * CYL_N}: N={st5.n}, one step: "
         f"poisson_iters {int(aux5.poisson_iters)} relres {float(aux5.poisson_relres):.3e}, "
         f"helmholtz_iters {int(aux5.helmholtz_iters)}, vmax {float(aux5.status.vmax):.6e}, "
         f"overflow {int(aux5.neighbor_overflow)}, finite "
         f"{bool(torch.isfinite(st5.v).all())}; peak "
         f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB (a record, no bar: JAX on the "
         f"CPU stops at its 750-iteration cap, relres 3.16e-5)")
    return launches, sim, state, iters


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
            errs.append(err)
            _log(f"mls operators: {name} n={n} N={state.n} K={A.vals.shape[0]}: max residual "
                 f"{err:.6e} (peak {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} "
                 f"GiB above the start)")
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

    rk = solve(A, fac, b, x0)
    fc = build_ilu0(Ac)
    rc = solve(Ac, fc, b.cpu(), x0.cpu())
    for where, res in (("card", rk), ("CPU", rc)):
        _log(f"extras ilu: step-1 Helmholtz ILU(0) GMRES on the {where}: (iterations, relres) "
             f"{[(int(r.iters), float(r.relres)) for r in res]}")
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
    from isph_tpu_torch.ops import comp_dot_cuda as cd
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.physics import ns_projection as ns
    from isph_tpu_torch.solvers.ilu import build_ilu0, row_slots
    from isph_tpu_torch.solvers.krylov import gmres
    from isph_tpu_torch.solvers.precond import chebyshev, jacobi

    wrappers = (sc.ell_spmv, sc.take, cd.comp_dots)
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
    fac = build_ilu0(A)
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
    if min(out["launches_recycle"].values()) <= 0:
        raise RuntimeError(f"a kernel of the recycling path never launched: "
                           f"{out['launches_recycle']}")
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
    if min(out["launches_pipelined"].values()) <= 0:
        raise RuntimeError(f"a kernel of the pipelined CG path never launched: "
                           f"{out['launches_pipelined']}")
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
        res = gmres(A.matvec, b[0], state0.v[0], M=M, tol=tol)
        _log(f"extras chebyshev: GMRES with {name}: {int(res.iters)} iterations, relres "
             f"{float(res.relres):.3e}, converged {bool(res.converged)}")
        if name != "jacobi" and not bool(res.converged):
            raise RuntimeError("GMRES with Chebyshev did not converge")
    return out


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
    nbrs, geom = _qeq_geometry(x, valid, dom, cap)
    cmax = int(nbrs.count.max())
    del nbrs
    geo_peak = torch.cuda.max_memory_allocated() - base
    _log(f"qeq: N={n} K={QEQ_K} cell capacity {cap}; neighbor build and geometry peak "
         f"{geo_peak / 2**30:.2f} GiB above the positions; count.max {cmax}")
    torch.cuda.reset_peak_memory_stats()
    st = qeq.QEqState.zeros(n, device=dev)
    calls = []
    for call in range(6):
        res = qeq.solve_qeq(geom, tid, params, st, valid)
        st = res.state
        qsum, qabs = float(st.q.sum()), float(st.q.abs().sum())
        calls.append((int(res.s_info.iters), int(res.t_info.iters)))
        _log(f"qeq: call {call + 1}: s {calls[-1][0]} iterations relres "
             f"{float(res.s_info.relres):.3e}, t {calls[-1][1]} relres "
             f"{float(res.t_info.relres):.3e}; sum q {qsum:.3e} (sum |q| {qabs:.6e})")
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

def _sharded(sim, state, group, halo=None, n_loc=None, **kw):
    """The ShardedSimulation of ``state`` on ``group`` and this rank's slab:
    without ``n_loc`` it comes from choose_n_loc; without ``halo`` the halo
    holds the fuller face's cut layer (the particles within the cutoff of a
    slab face) with 25% slack, rounded up to 128."""
    from isph_tpu_torch.parallel.sharded import (ShardedSimulation, choose_n_loc,
                                                 partition_state, slab)

    dom = sim.domain
    if n_loc is None:
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


# the JAX package's sharded TGV-32 f64 steps (h_factor 1.6) at world size 1
# in scripts/weak_scaling.py's layout (n_loc = halo = 1536, migrate_cap 192)
# on the CPU: (Poisson iterations, Helmholtz iterations, kinetic energy,
# vmax) after steps 1-3
WEAK_JAX = ((35, 10, 0.08750189298603842, 0.09345186972415728),
            (25, 10, 0.07786882414824536, 0.08836063442034693),
            (30, 10, 0.06929584582344786, 0.08350520390057886))


def _sharded_weak(dev, group):
    """(e) scripts/weak_scaling.py's world-size-1 layout, the halo as wide
    as the slab: three f64 TGV-32 steps against JAX's sharded step
    (WEAK_JAX).  Helmholtz counts equal at every step, Poisson counts from
    step 2, KE and vmax within 1e-9 relative.  Step 1's Poisson count is
    logged beside JAX's: the start is divergence-free, its right-hand side
    is round-off, and the count follows its last bits (the CPU tests hold
    the port's first solve to JAX's count on JAX's right-hand side)."""
    from isph_tpu_torch.models import tgv
    from isph_tpu_torch.parallel.sharded import ShardedSimulation, partition_state, slab

    sim, state = tgv.make_tgv(32, h_factor=1.6, device=dev)
    n_loc = 1536
    ss = ShardedSimulation(sim=sim, group=group, n_loc=n_loc, halo=n_loc, migrate_cap=192)
    st = ss.prepare(slab(partition_state(state, sim.domain, 1, n_loc), 0, n_loc))
    for k, (jp, jh, jke, jv) in enumerate(WEAK_JAX):
        st, aux = ss.step(st)
        p, h = int(aux.poisson_iters), int(aux.helmholtz_iters)
        ke, vmax = float(aux.status.kinetic_energy), float(aux.status.vmax)
        d_ke, d_v = abs(ke / jke - 1.0), abs(vmax / jv - 1.0)
        _log(f"sharded weak layout: TGV-32 f64 world 1, n_loc = halo = {n_loc}: step {k + 1}: "
             f"(poisson, helmholtz) ({p}, {h}), JAX ({jp}, {jh}); poisson relres "
             f"{float(aux.poisson_relres):.3e}; KE rel {d_ke:.2e}, vmax rel {d_v:.2e}")
        if h != jh or (k > 0 and p != jp) or max(d_ke, d_v) > 1e-9:
            raise RuntimeError(f"the weak-scaling layout's step {k + 1} departs from JAX's")
        if int(aux.neighbor_overflow) != 0:
            raise RuntimeError("the weak-scaling layout overflowed")


def phase_sharded(dev, flush, large):
    """Phase 26: the sharded step at world size 1 on NCCL, in-process."""
    from isph_tpu_torch.ops import comp_dot_cuda as cd
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
        iters = []
        st, aux, launches = _run_steps("sharded", sim, st,
                                       (sc.ell_spmv, sc.take, cd.comp_dots),
                                       each=_record_iters(iters), step=ss.step)
        if min(launches.values()) <= 0:
            raise RuntimeError(f"a kernel never launched on the sharded path: {launches}")
        ke, vmax = float(aux.status.kinetic_energy), float(aux.status.vmax)
        d_ke, d_v = abs(ke / large["ke"] - 1.0), abs(vmax / large["vmax"] - 1.0)
        _log(f"sharded: KE {ke!r} (phase 7 {large['ke']!r}, rel {d_ke:.3e}), vmax {vmax!r} "
             f"(phase 7 {large['vmax']!r}, rel {d_v:.3e}), nfluid {float(aux.status.nfluid)!r}; "
             f"(helmholtz, poisson) iterations {iters} beside phase 7's {large['iters']}")
        if max(d_ke, d_v) > 1e-4 or float(aux.status.nfluid) != large["nfluid"]:
            raise RuntimeError("the sharded 1M step departs from phase 7's")
        kd = _sharded_kernels(flush, ss, st)
        del sim, state, ss, st, aux
        torch.cuda.empty_cache()
        # (b) exactness; (e) the weak-scaling layout against JAX's sharded step
        _sharded_exact(dev, group)
        _sharded_weak(dev, group)
    finally:
        mesh.close_mesh()
    return dict(launches=launches, **kd)


# ---------------------------------------------------------------------------
# phase 27: the sharded MLS/ALE step, distributed QEq and the multichip entry
# ---------------------------------------------------------------------------

def _sharded_ale(dev, group, flush, cyl_iters):
    """(a) flow-past-cylinder-2d-mls at n = 256 (65,536 particles, f64,
    K = 48, fully periodic) through ShardedSimulation.step at world size 1:
    three steps, each Poisson relres < 1e-6 and vmax within 1e-5 of JAX's
    (phase 21's bar), no overflow; the iterations beside phase 21's, the
    peak memory and the collectives of a fourth step.  (d) on the step-3
    slab: ell_spmv on the extended slab's ALE Poisson matrix (f64 C = 1) and
    take on the slab list (f64 pressure, int32 kinds) against their plain
    versions as in phase 3.  Returns (launches, kernel rows)."""
    from isph_tpu_torch.models import decks
    from isph_tpu_torch.ops import spmv_cuda as sc

    sim, state = decks.build_deck(CYL, n=CYL_N, device=dev)
    ss, st, layer = _sharded(sim, state, group)
    _log(f"sharded ale: world size 1 on NCCL; {CYL} n={CYL_N} N={state.n} f64: n_loc={ss.n_loc} "
         f"halo={ss.halo} (cut layer {layer[0]} and {layer[1]} particles at the two x-faces), "
         f"local cell capacity {ss._local_cell_capacity()}")
    bad, iters = [], []

    def each(k, _, aux):
        vmax = float(aux.status.vmax)
        rel = vmax / CYL_JAX_VMAX[k] - 1.0
        iters.append((int(aux.helmholtz_iters), int(aux.poisson_iters)))
        _log(f"sharded ale: step {k + 1}: vmax {vmax:.17g} (JAX {CYL_JAX_VMAX[k]:.17g}, "
             f"{rel:+.2e})")
        if not (float(aux.poisson_relres) < 1e-6 and abs(rel) < 1e-5):
            bad.append(k + 1)

    st, aux, launches = _run_steps("sharded ale", sim, st, (sc.ell_spmv, sc.take),
                                   cap_check=False, each=each, step=ss.step)
    if bad:
        raise RuntimeError(f"sharded cylinder steps {bad}: Poisson relres >= 1e-6 or vmax off "
                           "JAX's")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel never launched on the sharded ALE path: {launches}")
    _log(f"sharded ale: (helmholtz, poisson) iterations {iters} beside phase 21's {cyl_iters}")
    group.reset()
    ss.step(st)
    _log(f"sharded ale: step 4: {group.allreduces} all-reduces, {group.ring_hops} ring hops")

    ext, _, geom, _, _ = ss._borders(st, *ss._slab_bounds(st.dtype, st.device))
    A, _ = _ale_poisson_matrix(sim, ext, geom)
    K, n = A.vals.shape
    nnz = int(A.mask.sum().item()) + n
    _log(f"sharded ale kernels: extended slab N={n} (n_loc {ss.n_loc} + 2 x halo {ss.halo}) "
         f"K={K} nnz={nnz}")
    rng = np.random.default_rng(27)
    spmv, err = _sweep_ell("sharded ale kernels: spmv ALE Poisson", A, nnz, flush, rng,
                           ((torch.float64, (1,)),))
    shapes = ("f64 (N,) p", "int32 (N,) kind")
    take = _take_sweep("sharded ale kernels: take", sc.take, geom.idx,
                       dict(zip(shapes, (ext.p, ext.kind))), flush, main_shapes=shapes)
    return launches, dict(spmv=spmv[(torch.float64, 1)], take=take["f64 (N,) p"], spmv_err=err)


def _sharded_qeq(dev, group, flush):
    """(b) phase 25's 262,144-atom lattice (f64, K = 448, cutoff 10 A) as one
    world-size-1 slab (n_loc = N: QEq moves no atom; the halo the cut layer
    + 25%), its type ids on ``phase``: the borders build, then solve_qeq
    with the halo refresh and the group against the one-device solve_qeq
    on the same atoms at QEQ_CHECK_TOL: q on the owned rows within 1e-10 of
    the one-device solve's, the s/t iterations equal; then two calls at tol
    1e-6 from a zero history, with their collectives.  (d)
    ell_spmv on the extended slab's H (f64 C = 2) and take on its type ids
    (int32 (N,)).  Returns (launches, kernel rows)."""
    from isph_tpu_torch.config import (KernelConfig, KernelType, NeighborConfig,
                                       SimulationConfig)
    from isph_tpu_torch.models.driver import Simulation
    from isph_tpu_torch.ops import spmv_cuda as sc
    from isph_tpu_torch.physics import qeq
    from isph_tpu_torch.state import Kind, make_state

    x, valid, tid, dom, cap = _qeq_setup(QEQ_SIDE, dev)
    n = x.shape[1]
    check = qeq.QEqParams(**{**QEQ_PARAMS, "tol": QEQ_CHECK_TOL, "maxiter": 1000})
    _, geom = _qeq_geometry(x, valid, dom, cap)
    r = qeq.solve_qeq(geom, tid, check, qeq.QEqState.zeros(n, device=dev), valid)
    q_ref, its_ref = r.state.q, (int(r.s_info.iters), int(r.t_info.iters))
    del geom, r
    torch.cuda.empty_cache()

    cut = QEQ_PARAMS["swb"]
    cfg = SimulationConfig(dim=3, h=cut / 2.0, dt=1.0,
                           kernel=KernelConfig(type=KernelType.WENDLAND, cut_over_h=2.0),
                           neighbor=NeighborConfig(max_neighbors=QEQ_K, cell_capacity=cap))
    state = make_state(x.T.cpu().numpy(), kind=np.full(n, Kind.FLUID_BIT, np.int32), rho=1.0,
                       nu=0.0, pad_to=n, dtype=torch.float64, device=dev).replace(phase=tid)
    ss, st, layer = _sharded(Simulation(cfg=cfg, domain=dom), state, group, n_loc=n)
    for w in (sc.ell_spmv, sc.take):
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ext, comm, geom, _, ovf = ss._borders(st, *ss._slab_bounds(st.dtype, st.device))
    n_ext = ext.x.shape[-1]

    def solve(params, qs):
        return qeq.solve_qeq(geom, ext.phase, params, qs, comm.owned, group=group,
                             exchange=comm.refresh)

    _log(f"sharded qeq: world size 1 on NCCL; N={n} N_ext={n_ext} (halo {ss.halo}, cut layer "
         f"{layer[0]} and {layer[1]} atoms), overflow {int(ovf)}")
    res = solve(check, qeq.QEqState.zeros(n_ext, device=dev))
    its = (int(res.s_info.iters), int(res.t_info.iters))
    dq = float((res.state.q[:n] - q_ref).abs().max())
    _log(f"sharded qeq: tol {check.tol:.0e}: s/t iterations {its} (one device {its_ref}), q "
         f"on the owned rows within {dq:.3e} of the one-device q")
    if int(ovf) != 0 or its != its_ref or not dq <= 1e-10:
        raise RuntimeError(f"the sharded QEq solve departs from the one-device solve at tol "
                           f"{QEQ_CHECK_TOL:.0e}")
    params = qeq.QEqParams(**QEQ_PARAMS)
    qs = qeq.QEqState.zeros(n_ext, device=dev)
    for call in range(2):
        group.reset()
        r = solve(params, qs)
        qs = r.state
        q = r.state.q[:n]
        _log(f"sharded qeq: call {call + 1} at tol {params.tol:g}: s/t "
             f"{int(r.s_info.iters)}/{int(r.t_info.iters)}, {group.allreduces} all-reduces, "
             f"{group.ring_hops} ring hops; sum q {float(q.sum()):.3e}")
        if not (bool(r.s_info.converged) and bool(r.t_info.converged)):
            raise RuntimeError(f"sharded QEq call {call + 1} did not converge")
    launches = {"ell_spmv": sc.ell_spmv.launches, "take": sc.take.launches}
    _log(f"sharded qeq: launches {launches}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
         f"GiB")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel never launched on the sharded QEq path: {launches}")

    H = qeq.assemble_h(geom, ext.phase, params, comm.owned)
    nnz = int(H.mask.sum().item()) + n_ext
    rng = np.random.default_rng(28)
    spmv, err = _sweep_ell("sharded qeq kernels: spmv H", H, nnz, flush, rng,
                           ((torch.float64, (2,)),))
    take = _take_sweep("sharded qeq kernels: take", sc.take, H.idx, {"int32 (N,)": ext.phase},
                       flush, main_shapes=("int32 (N,)",))
    return launches, dict(spmv=spmv[(torch.float64, 2)], take=take["int32 (N,)"], spmv_err=err)


def phase_sharded_rest(dev, flush, cyl_iters):
    """Phase 27: (a) and (b) at world size 1 on NCCL in this process, the
    launch counters set to 0 around each; the group closed, then (c)
    entry.dryrun_multichip on every card of the machine, one NCCL rank each."""
    from isph_tpu_torch import entry
    from isph_tpu_torch.parallel import mesh

    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    group = mesh.make_mesh(1, 0, backend="nccl", init_file=os.path.join(store, "store"),
                           device=dev)
    try:
        launches_ale, kale = _sharded_ale(dev, group, flush, cyl_iters)
        torch.cuda.empty_cache()
        launches_qeq, kqeq = _sharded_qeq(dev, group, flush)
        torch.cuda.empty_cache()
    finally:
        mesh.close_mesh()
    n_cards = torch.cuda.device_count()
    out = entry.dryrun_multichip(n_cards, device=dev)
    _log(f"multichip entry: dryrun_multichip({n_cards}) on NCCL passed: {out}")
    return dict(launches_ale=launches_ale, launches_qeq=launches_qeq, ale=kale, qeq=kqeq)


def phase_bench(dev):
    """Phase 28: the port's bench (isph_tpu_torch/bench.py) with its
    --small set in this process, the launch counters set to 0 just before
    and read just after: bench.py's line with every key of its small set,
    the numbers finite and positive, the device named as nvidia-smi names
    it, and both kernels of the set launched."""
    from isph_tpu_torch import bench
    from isph_tpu_torch.ops import comp_dot_cuda as cd
    from isph_tpu_torch.ops import spmv_cuda as sc

    wrappers = (sc.ell_spmv, sc.take, sc.ell_spmv_band, sc.take_band, cd.comp_dots)
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    line = bench.run_benches(small=True, dev=dev)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    _log(f"bench --small: {json.dumps(line)}")
    _log(f"bench --small: launches {launches}")
    ex = line["extras"]
    missing = [k for k in bench.SMALL_KEYS if k not in ex]
    numbers = {"value": line["value"], "vs_baseline": line["vs_baseline"],
               **{k: ex[k] for k in bench.SMALL_KEYS if k in ex
                  and k not in ("tgv2d_best_precond", "device")}}
    bad = [k for k, v in numbers.items() if not (isinstance(v, (int, float))
                                                   and math.isfinite(v) and v > 0)]
    if missing or bad or line["metric"] != "spmv_nnz_per_s" or line["unit"] != "nnz/s":
        raise RuntimeError(f"the bench's small line: missing {missing}, not finite and "
                           f"positive {bad}")
    if ex["tgv2d_best_precond"] not in ("amg", "jacobi") or ex["device"] != _smi():
        raise RuntimeError(f"the bench's line names {ex['device']!r}, best precond "
                           f"{ex['tgv2d_best_precond']!r}")
    if min(launches["ell_spmv"], launches["take"], launches["comp_dots"]) <= 0:
        raise RuntimeError(f"a kernel of the bench's small set never launched: {launches}")
    return launches


def _phase(label, fn, *args, **kw):
    """``fn(*args, **kw)`` with its wall time logged on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    _log(f"phase {label}: {time.perf_counter() - t0:.2f} s")
    return out


def _flush(dev):
    """An L2-sized buffer that the kernel sweeps overwrite before a cold call."""
    torch.cuda.empty_cache()
    return torch.empty(32 * 2**20, dtype=torch.float32, device=dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA device", file=sys.stderr)
        return 2
    from isph_tpu_torch import _build

    t_start = time.perf_counter()
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
    flush = _flush(dev)
    k = _phase("3 (kernels)", phase_kernels, dev, flush)

    # phase 29: the compensated dot kernel against the plain cascade
    kd = _phase("29 (compensated dot)", phase_comp_dot, dev, flush)

    # phase 30: the AMG transfer kernels at the cells' shapes
    ka = _phase("30 (AMG transfers)", phase_agg_transfer, dev, flush)
    del flush

    # phase 31: the neighbor search kernel against the plain blocked search
    kn = _phase("31 (neighbor search)", phase_neighbor_search, dev)
    torch.cuda.empty_cache()

    # phase 32: the correction-tensor kernel against compute_pre's plain chain
    kpre = _phase("32 (correction tensors)", phase_corrected_pre, dev)
    torch.cuda.empty_cache()

    # phase 33: the AMG coarse-cycle kernel at the cells' hierarchies
    kac = _phase("33 (AMG coarse cycle)", phase_amg_coarse, dev)

    # phase 4: main path; phase 5: golden
    launches, tgv_sim, tgv_state, tgv_t, main_iters = _phase("4 (main path)",
                                                             phase_main_path, dev)
    golden_dots = _phase("5 (golden)", phase_golden, dev)

    # phase 6: band kernels at 1M; phase 7: the large-N path
    flush = _flush(dev)
    kb = _phase("6 (band kernels)", phase_band_kernels, dev, flush)
    del flush
    torch.cuda.empty_cache()
    launches_large, large = _phase("7 (large N)", phase_large_n, dev)

    # phase 8: 3-D kernels; phase 9: the 3-D path; phase 10: channel
    # kernels; phase 11: the channel path
    flush = _flush(dev)
    k3 = _phase("8 (3-D kernels)", phase_3d_kernels, dev, flush)
    del flush
    torch.cuda.empty_cache()
    launches_3d = _phase("9 (3-D path)", phase_3d_path, dev)
    flush = _flush(dev)
    kc = _phase("10 (channel kernels)", phase_channel_kernels, dev, flush)
    del flush
    torch.cuda.empty_cache()
    launches_channel = _phase("11 (channel)", phase_channel, dev)

    # phase 12: electrokinetic kernels; phase 13: electrokinetic goldens;
    # phase 14: the electroosmotic channel; phase 15: transport
    flush = _flush(dev)
    ke = _phase("12 (electrokinetic kernels)", phase_edl_kernels, dev, flush)
    del flush
    torch.cuda.empty_cache()
    _phase("13 (electrokinetic goldens)", phase_edl_golden, dev)
    launches_edl = _phase("14 (electroosmotic channel)", phase_edl_path, dev)
    torch.cuda.empty_cache()
    launches_transport = _phase("15 (transport)", phase_transport, dev)

    # phase 16: walls and entry points
    torch.cuda.empty_cache()
    launches_walls = _phase("16 (walls, entry points)", phase_walls, dev, tgv_sim, tgv_state,
                            tgv_t)

    # phase 18: the 3-D multiphase pore-scale deck at its own size; phase 17:
    # the kernels on its step-1 state; phase 19: the droplet, the micelle
    # and the random stress
    torch.cuda.empty_cache()
    launches_pore3d, pore_sim, pore_state = _phase("18 (pore-scale deck)", phase_pore3d, dev)
    flush = _flush(dev)
    kp = _phase("17 (pore-scale kernels)", phase_pore3d_kernels, dev, flush, pore_sim,
                pore_state)
    del flush, pore_sim, pore_state
    torch.cuda.empty_cache()
    launches_droplet = _phase("19a (droplet)", phase_droplet, dev)
    _phase("19b (micelle)", phase_micelle, dev)
    rs_dots = _phase("19c (random stress)", phase_random_stress, dev, tgv_sim, tgv_state)

    # phase 20: the n = 32 cylinder golden; phase 21: the cylinder at size;
    # phase 23: the MLS operator decks; phase 22: the kernels on the
    # cylinder's and the 3-D operator deck's matrices
    torch.cuda.empty_cache()
    _phase("20 (cylinder golden)", phase_cylinder_golden, dev)
    launches_cyl, cyl_sim, cyl_state, cyl_iters = _phase("21 (cylinder)", phase_cylinder, dev)
    torch.cuda.empty_cache()
    A3 = _phase("23 (MLS operator decks)", phase_mls_operators, dev)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    km = _phase("22 (MLS kernels)", phase_mls_kernels, dev, flush, cyl_sim, cyl_state, A3)
    del flush, A3, cyl_sim, cyl_state

    # phase 24: the solver extras on the main path; phase 25: QEq at size
    flush = _flush(dev)
    kx = _phase("24 (solver extras)", phase_solver_extras, dev, flush, main_iters, tgv_state)
    kq = _phase("25 (QEq)", phase_qeq, dev, flush)

    # phase 26: the sharded step at world size 1 on NCCL; phase 27: the
    # sharded ALE step, distributed QEq and the multichip entry
    torch.cuda.empty_cache()
    ks = _phase("26 (sharded)", phase_sharded, dev, flush, large)
    torch.cuda.empty_cache()
    kr = _phase("27 (sharded rest)", phase_sharded_rest, dev, flush, cyl_iters)
    del flush

    # phase 28: the bench's --small set
    del tgv_sim, tgv_state
    torch.cuda.empty_cache()
    launches_bench = _phase("28 (bench --small)", phase_bench, dev)
    _log(f"chip_smoke: all phases {time.perf_counter() - t_start:.1f} s")

    def row(name, source, replaces, launched, err, t):
        return dict(name=name, route="cuda", source=f"isph_tpu_torch/csrc/{source}",
                    replaces=f"isph_tpu/ops/spmv_pallas.py:{replaces}", launches=launched,
                    max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], launches_bench=launches_bench[name])

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
        (f32) and the boundary strip (f32 (N,)); phase 27's extended-slab
        ALE Poisson matrix (f64 C = 1) and pressure gather (f64 (N,)) with
        the launches of the three sharded cylinder steps, and its
        extended-slab QEq H (f64 C = 2) and type ids (int32 (N,)) with the
        launches of the sharded QEq's borders build and three solves."""
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
        extras.update(at_sharded_ale=times(kr["ale"][kname]),
                      at_sharded_qeq=times(kr["qeq"][kname]))
        return dict(launches_3d=launches_3d[name], launches_channel=launches_channel[name],
                    launches_sharded_ale=kr["launches_ale"][name],
                    launches_sharded_qeq=kr["launches_qeq"][name],
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
                   kq["spmv_err"], ks["spmv_err"], kr["ale"]["spmv_err"],
                   kr["qeq"]["spmv_err"]), k["spmv"]),
         **beyond("ell_spmv")},
        {**row("take", "take.cu", 332, launches["take"], 0.0, k["take"]), **beyond("take")},
        row("ell_spmv_band", "spmv_band.cu", 458, launches_large["ell_spmv_band"],
            kb["spmv_err"], kb["spmv"]),
        row("take_band", "take_band.cu", 635, launches_large["take_band"], 0.0, kb["take"]),
        dict(name="comp_dots", route="cuda", source="isph_tpu_torch/csrc/comp_dot.cu",
             replaces="isph_tpu/utils/fsum.py:56", launches=launches["comp_dots"],
             max_abs_err=max(r["err"] for r in kd.values()), **times(kd[COMP_DOT_MAIN]),
             launches_bench=launches_bench["comp_dots"],
             launches_large=launches_large["comp_dots"], launches_3d=launches_3d["comp_dots"],
             launches_channel=launches_channel["comp_dots"],
             launches_walls=launches_walls["comp_dots"],
             launches_ilu=kx["launches_ilu"]["comp_dots"],
             launches_recycle=kx["launches_recycle"]["comp_dots"],
             launches_pipelined=kx["launches_pipelined"]["comp_dots"],
             launches_sharded=ks["launches"]["comp_dots"], launches_golden=golden_dots,
             launches_edl_f32=launches_edl["comp_dots_f32"], launches_random_stress=rs_dots,
             **{f"at_{label.replace(' ', '_').replace('=', '')}": times(t)
                for label, t in kd.items() if label != COMP_DOT_MAIN}),
    ]
    for name, op in (("agg_restrict", "restrict"), ("agg_prolong_add", "prolong_add")):
        kernels.append(dict(
            name=name, route="cuda", source="isph_tpu_torch/csrc/agg_transfer.cu",
            replaces="none (XLA's one-hot products, isph_tpu/solvers/amg.py)",
            launches=launches_large[name], launches_3d=launches_3d[name],
            max_abs_err=max(r["err"] for k, r in ka.items() if k.startswith(op + " ")),
            **times(ka[f"{op} {AGG_MAIN}"]),
            **{f"at_{k[len(op) + 1:].replace(' ', '_').replace('^', '')}": times(r)
               for k, r in ka.items() if k.startswith(op + " ") and not k.endswith(AGG_MAIN)}))
    kernels.append(dict(
        name="neighbor_search", route="cuda", source="isph_tpu_torch/csrc/neighbor_search.cu",
        replaces="none (XLA's search, isph_tpu/ops/neighbors.py)",
        launches=launches["neighbor_search"], launches_large=launches_large["neighbor_search"],
        launches_3d=launches_3d["neighbor_search"], max_abs_err=0.0,
        **times(kn["64^3 Quintic"]), at_1M=times(kn["1M band"])))
    kernels.append(dict(
        name="corrected_pre", route="cuda", source="isph_tpu_torch/csrc/corrected_pre.cu",
        replaces="none (XLA's computePre, isph_tpu/ops/corrected.py)",
        launches=launches["corrected_pre"], launches_large=launches_large["corrected_pre"],
        launches_3d=launches_3d["corrected_pre"], max_abs_err=kpre["err"],
        **times(kpre["rows"]["64^3 Quintic f32"]),
        **{f"at_{k.replace(' ', '_').replace('^', '')}": times(r)
           for k, r in kpre["rows"].items() if k != "64^3 Quintic f32"}))
    kernels.append(dict(
        name="amg_coarse_cycle", route="cuda", source="isph_tpu_torch/csrc/amg_coarse.cu",
        replaces="none (XLA's roll stencils, isph_tpu/solvers/amg.py:339)",
        launches=launches_large["amg_coarse_cycle"],
        launches_3d=launches_3d["amg_coarse_cycle"],
        max_abs_err=max(r["err"] for r in kac.values()),
        **times(kac[AMG_COARSE_CASES[0][0]]),
        **{f"at_{k}": times(r) for k, r in kac.items() if k != AMG_COARSE_CASES[0][0]}))
    print(_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
