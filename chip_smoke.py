#!/usr/bin/env python3
"""Smoke test of quinoa_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Drives the port's three DG(P1) paths and its two ALECG paths at 48^3
(663,552 tets; 117,649 nodes and 795,024 edges), its two DiagCG + FCT
paths (SlotCyl at 64^3: 1,572,864 tets and 274,625 nodes; VorticalFlow at
48^3), its DG(P2) path (TaylorGreen at 32^3: 196,608 tets, 399,360
faces), its DG(P0) Sod path, its three multi-material paths, its
Lax-Friedrichs Sod DG(P1) path and its two THINC interface-advection paths
(extrapolate and Dirichlet faces, 48^3) in float32 through their
hand-written CUDA kernels, the Sedov DG(P1) deck through the port's
inciter command, mesh refinement (t0ref, dtref) and tracer particles
through the command and its helpers, the walker (its Threefry draws,
every SDE class, the coupled Langevin family at 10^6 particles and the
walker command), the rngtest command and batteries, and meshconv:

1. card    the name and power limit from nvidia-smi;
2. build   compile csrc/*.cu with nvcc (sm_90a), one process per source,
           and load the library;
3. kernels each kernel against its plain torch version on the card:
           K1, K12 and K13 (p1's face pass) and K4 on a perturbed Sedov
           state (K1, K12 and K13 bit for bit, a NaN matching a NaN, as
           every K12 and K13 instance below), K5 and K6 on GaussHump
           transport rows, float32 at 48^3 and float64 on small meshes,
           with the device time of the kernel at 48^3 (device_ms: CUDA
           events around a call the host enqueued in full while a spin
           kernel held the card, in turns with the one-call yardstick,
           each call from a cold L2) and the host-inclusive one-call time
           of the kernel (call_ms) and of the plain version;
           K7-K9 (both flavours of K7 and K8) on the SlotCyl and
           VorticalFlow initial states, alone and as the stage rhs, bit
           for bit (also, untimed, SlotCyl with three components and
           ALECG_TAIL, a box whose edge and element counts leave K8 a
           ragged last run and K7 a ragged last block);
           K10 (1 and 5 rows) and K11 at the three calls of a step of
           each DiagCG leg (rhs + diffusion sums, P sums + Q maxima,
           limited A sums; K9 and K11 bit for bit), max rows alone and a
           NaN in a max row, on the DiagCG meshes; K12 and K13 on the
           32^3 P2 TaylorGreen initial state (float64 on a small P2 mesh);
           K12 and K13 at (K, G) = (1, 1) on a perturbed 48^3 Sod state,
           K14 mm_face_wflux (nmat 2 at P0 and
           P1, nmat 3 at P0) and K13 at its 16 and 22 rows on perturbed
           multimat states, K4 at mm_p1's 9 components, K5 on
           mm_iface's 12 rows and K6 on its Dirichlet face rows (22)
           (float64 on small meshes); the Lax-Friedrichs flavour of K12
           on a perturbed, limited 48^3 Sod P1 state (and at K = 1, 4 and
           10 in float64), the THINC flavour of K14 (nmat 3) with K13 at 22
           rows and K4 at 12 components on the limited 48^3 interface
           advection state (THINC at nmat 2 and 3 in float64), with the
           share of THINC-flagged face points; K5 at mm_iface_p1's 108
           rows (state and THINC carriers) and 48 rows (the dt sweep's
           state) and K6 at its 88 face rows onto the volume term, bit for
           bit, on that path's limited initial state (float32 at 48^3,
           float64 on the small mesh); each timed kernel
           also gets its bound (bytes of its inputs read once and outputs
           written once over 3.35 TB/s, or its operations over 67 TFLOP/s,
           whichever is larger) and, where one PyTorch call computes the
           same function, that call's device time; then nine small float64
           solvers on the card against the same solvers on the CPU (Sedov
           P1, Sedov pdg, GaussHump, GaussHump pdg, ALECG and DiagCG
           SlotCyl and VorticalFlow, P2 TaylorGreen: 2 steps, u atol
           1e-11, dt rtol 1e-12, ndofel equal where the state has one),
           seven more (P0 Sod, the three multimat paths, p1_lf, mm_thinc
           and mm_iface_p1; u atol 1e-11 of max(1, max|u|)) and the ten
           SCHEMES solvers the same way (Sedov P1 with wenop1, Sedov
           p0p1 with Superbee, NLEnergyGrowth P1 with Superbee on walls,
           RayleighTaylor P1 on Dirichlet faces, GaussHump P2, TaylorGreen
           P2 with Superbee, DiagCG with CylAdvect, ShearDiff (diffusion,
           from t = 1) and RayleighTaylor, ALECG with RayleighTaylor);
4. p1      the Sedov DG(P1) HLLC + Superbee step (bench.py) from its
           initial_state(): 1 warm-up and 10 timed steps through K1, K12
           and K13, 33 launches each, then 5 steps under torch.profiler
           (wall, device busy and idle, launches a step); then the same
           11 steps from the initial state tools/bench_l2_known_good.json
           was harvested from (see tpu_precision_initial_u), whose L2(sol)
           must match that file at rtol 5e-4;
5. pdg     the p-adaptive Sedov step (bench.py --pdg): 1 + 10 steps
           through K4, K12 and K13, 33 launches each; finite, with P0 and
           P1 elements; then 5 steps under torch.profiler;
6. hump    GaussHump transport on Dirichlet faces (the face Gauss-point
           path): 1 + 10 steps through K5 (left and right face states of
           every rhs and dt sweep: 8 launches a step) and K6 (3 a step);
           finite, and L2(err) < 0.5 L2(sol) against the analytic hump;
7. alecg   ALECG SlotCyl transport (bench_alecg.py): 1 + 10 steps through
           K7 alecg_vol, K8 alecg_edge and K9 cg_assemble, 3 launches each
           a step; finite, L2(sol) and L2(err) against the JAX package's
           CPU result (JAX_L2);
8. alecg_cf ALECG VorticalFlow Euler (bench_alecg.py --compflow): the same
           through K7 alecg_vol_cf, K8 alecg_edge_cf and K9;
9. diagcg  DiagCG + FCT SlotCyl transport at 64^3 (bench_cg.py): 1 + 10
           steps through K10 node_gather and K11 node_assemble, 3 launches
           each a step; finite, L2(sol) and L2(err) against the JAX
           package's CPU result (JAX_L2), min and max within BOUNDS_ULPS
           float32 ulps of the initial bounds; then 5 steps under
           torch.profiler (wall, device busy and idle, launches a step);
10. diagcg_cf DiagCG + FCT VorticalFlow Euler at 48^3: the same, without
           the bounds check;
11. p2      DG(P2) TaylorGreen (bench.py --dgp2: HLLC, symmetry walls, cfl
           0.5, no limiter) at 32^3: 1 + 10 steps through K12 face_wflux
           and K13 basis_accum, 3 launches each a step; finite, L2(sol)
           and L2(err) against the JAX package's CPU result (JAX_L2); then
           5 steps under torch.profiler and the host time of a stage's
           volume integral, source and face pass;
12. p0      Euler DG(P0) SodShocktube at 48^3 (extrapolate on the x faces,
           symmetry on the others, cfl 0.5): 1 + 10 steps through K12 and
           K13 at (1, 1), 3 launches each a step;
13. mm_p0   two-material MMSodShocktube, MultiMatSolver DG(P0), same mesh
           and faces, cfl 0.5: through K14 and K13 (16 rows);
14. mm_p1   the same at DG(P1) with consistent Superbee: K4, K14, K13;
15. mm_iface three-material MMInterfaceAdvection at DG(P0), Dirichlet on
           all six sides, cfl 0.4: the Dirichlet route, K5 (8 a step) and
           K6 (3 a step);
16. p1_lf   Euler SodShocktube DG(P1) with the Lax-Friedrichs flux and
           Superbee, Sod faces, cfl 0.5: K1, the Lax-Friedrichs flavour of
           K12 (face_wflux_lf) and K13, 3 launches each a step;
17. mm_thinc three-material MMInterfaceAdvection at DG(P1) with THINC
           interface sharpening (beta 2.5) and consistent Superbee,
           extrapolate on all six sides, cfl 0.4: K4 (12 components), the
           THINC flavour of K14 (mm_face_wflux_thinc) and K13 (22 rows).
           Paths 12-18 gate L2(sol) after 11 steps against the JAX
           package's CPU float32 run (JAX_L2, jax_reference_l2.py) and,
           for multimat, the cell-mean fractions' minimum and sum; each
           ends with a torch.profiler window, mm_p1 and mm_thinc also with
           the host time of a stage's limiter, volume integral, face pass,
           non-conservative terms and alpha closure (mm_thinc: and its
           THINC carriers).
18. mm_iface_p1 the THINC interface advection of path 17 with Dirichlet
           on all six sides: the face Gauss-point route, K4 (3 a step), K5
           (8 a step: el and er of each stage's rhs on the state and its
           carriers, and of the stage-0 dt sweep) and K6 (3 a step), the
           ghost, THINC and AUSM+up in torch; gated like paths 12-17, with
           the host time of a stage's parts (the face Gauss-point pass and
           the dt sweep in place of K14 + K13).
19. cli     the Sedov DG(P1) deck of path 4 through the port's inciter
           command (quinoa_tpu_torch.cli.main, float32, on the card) on a
           48^3 ExodusII box it writes: run A (-r 6, field output at the
           end, --profile) launches K1, K12 and K13 33 times each and
           nothing else, and its row 11 prints the L2(sol) of an
           in-process DGSolver on path 4's geometry digit for digit; run B
           restarts from A's checkpoint and prints A's rows 7-11; run C
           (-b, one diag row, --profile) is timed against the in-process
           solver; A's field output reads back with the JAX package's
           names, finite; then one small float64 deck per build_inciter
           branch (CLI_SMALL) runs on the card and on the CPU, the diag
           rows agreeing at card_vs_cpu's tolerances, and one of them runs
           as `python3 -m quinoa_tpu_torch inciter`, which must exit 0;
           run D (A's deck, -b -v --profile --trace-dir) in a directory
           of its own: the three mesh statistics lines and the three mesh
           PDFs there, a Chrome trace holding as many device events of
           limit_vol, face_wflux and basis_accum as kernels.launches
           counts (33 each), run A's rows digit for digit, and its
           timestep ms/step beside run C's (the trace's overhead).
20. amr_small the AMR_SMALL decks (DiagCG SlotCyl with dtref in each of
           its three branches, Sedov DG(P1) with dtref, a t0ref deck of
           uniform, coords and uniform_derefine passes) through the command
           with -v on 6x6x2 boxes, float64, on the card and on the CPU: the
           same t0ref and dtref lines (element counts) and diag rows at
           card_vs_cpu's tolerances;
21. amr_dg  the Sedov DG(P1) deck at 48^3, float32, with dtref every 3
           steps (the incremental multi-level cycle; AMR_DG_DECK) through
           the command (-b -v --profile): K1, K12 and K13 33 launches each
           over the 11 steps of the solver and its rebuilds, the element
           count after each event, per-phase host seconds and ms/step
           between events (each step timed between synchronizes); gates:
           finite rows, an event that changes the mesh;
22. amr_cg  bench_cg.py's DiagCG SlotCyl at 64^3 with dtref every 4 steps
           one level above the base mesh (AMR_CG_DECK): the same report
           with K10 and K11; gates: finite rows, an event that changes the
           mesh, the final state within BOUNDS_ULPS of the initial bounds;
23. amr_remesh bench_amr.py's remesh leg at 32^3 (spherical front): the
           seconds of tagging, refinement, CG transfer, and the DiagCG
           solver's tables on the card (make_cggeom, DiagCGSolver);
24. t0ref   the Sedov DG(P1) deck on a 24^3 box refined 1:8 by t0ref
           (663,552 tets, as the 48^3 box): 11 finite steps, K1, K12, K13
           33 launches each, exactly 8 x 24^3 x 6 elements;
25. particles tracers: three velocity sources card against CPU in float64
           (5 steps, and the CLI's re-homing after a remesh: element ids
           equal, positions within 1e-12), then 10^5 tracers on the DiagCG
           SlotCyl 64^3 run (one dtref event, the incremental cycle) and
           on the Sedov DG(P1) 48^3 run, 11 float32 steps in process
           through the command's helpers (so no h5py is needed; the
           command's H5Part file is checked on the CPU): tracer ms/step,
           re-homing seconds;
           gates: positions finite, inside the box to 1e-6, every tracer
           that moved in the last step inside its element (barycentric
           minimum >= -1e-6);
26. walker  the raw-draw gate (WALKER_DRAW bits 32 and 64 wide and
           uniforms in float32 and float64 bit-identical on the card and
           the CPU, normals within WALKER_NORMAL_ULPS, 10^5 log-gamma
           draws at alpha 0.3 and 2.5 bit-identical); one walker per SDE
           class (14 walkers, the coupled family holding three classes)
           card against CPU in float64 (npar 4096, 5 steps, rtol 1e-12);
           the coupled Position + Velocity + Dissipation ensemble at 10^6
           particles in float32 timed as bench_walker.py times it (one
           warm-up chunk, 5 chunks of 10 steps each followed by its
           moments): particle-updates/s and ms/step, no hand kernel
           launched (PATHS["walker"] is empty), a torch.profiler window;
           gates: finite, mean dissipation > 0, each mean position within
           5 sigma/sqrt(npar) of 0; then `walker` through cli.main on the
           card and the CPU in float64, stat rows equal at the printed
           precision and the PDF's bins equal.
27. rngtest `rngtest --battery smallcrush --seed 7` through cli.main on the
           card (14/14 pass); SmallCrush again test by test on the card,
           each test's seconds split into draws on the card (with their
           copies to the host) and statistics on the host, every p-value
           equal to the port's CPU run's at RNG_RTOL; RANDU through the
           draw seam fails at least one of six equidistribution tests;
           Crush's five scomp entries (LinearComp x4 at n = 120000,
           LempelZiv at k = 25, reps 10) on the card's draws through the
           host library, with their seconds; no hand kernel launched.
28. meshconv a 48^3 box through `meshconv -v`: gmsh -> ExodusII classic ->
           netgen, and the 4 ExodusII pieces of a split joined; each output
           has the box's node, element and boundary-triangle counts, its
           connectivity and its coordinates (to CONV_COORD_ATOL: the text
           formats print 16 digits).  fileconv writes netCDF-4 through
           h5py, which the card's machine lacks: it runs only where h5py
           imports.

Every path that reports launches sets the counts to 0 just before it and
reads them just after; a kernel of the path that did not launch as
stated, or one that does not belong to it and launched, fails the run.
Any failure raises, so the script exits non-zero.  Paths 20-25 add no
kernel: their launches are those of the solvers rebuilt on each refined
mesh; paths 26-28 launch none.  Its last two lines are a JSON object of
the kernels and the result line {"ok": true, "device": {...}}.  Needs one
CUDA card, nvcc, a host C++ compiler and no network.
"""

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_BIG = 48                      # the bench box: 48^3 hexes, 6 tets each
N_P2 = 32                       # bench.py --dgp2's box
P2_SMALL = (4, 4, 3)            # float64 P2 mesh (tests/test_torch_dgp2.py)
SMALL = (6, 6, 4)               # float64 Sedov parity mesh
HUMP_SMALL = (10, 10, 2)        # float64 GaussHump mesh (tests/test_dg.py)
L2_RTOL = 5e-4                  # bench.py's gate
#: ALECG legs of bench_alecg.py: (problem, box lo, box hi, cfl); the small
#: float64 card-vs-CPU meshes are tests/test_alecg_fused.py's
ALECG = {"alecg": ("slotcyl", (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 0.8),
         "alecg_cf": ("vortical", (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5), 0.5)}
ALECG_SMALL = {"alecg": ((10, 10, 5), (0.0, 0.0, 0.0), (1.0, 1.0, 0.5), 0.8),
               "alecg_cf": ((8, 8, 8), (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5),
                            0.6)}
#: a box whose edge count (1675) is not a multiple of the runs of edges K8
#: gives a thread (its entry-by-entry loads and a ragged last run) and
#: whose element count (1134) leaves K7 a ragged last block; each leg's
#: ALECG_SMALL box and cfl otherwise
ALECG_TAIL = (9, 7, 3)
#: DiagCG + FCT legs: (problem, n, box lo, box hi, cfl); SlotCyl is
#: bench_cg.py at its default n = 64, VorticalFlow the configuration of
#: tests/test_cg_compflow.py at 48^3; the small float64 card-vs-CPU meshes
#: are tests/test_diagcg_transport.py's and tests/test_cg_compflow.py's
DIAGCG = {"diagcg": ("slotcyl", 64, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 0.8),
          "diagcg_cf": ("vortical", 48, (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5),
                        0.5)}
DIAGCG_SMALL = {"diagcg": ((16, 16, 4), (0.0, 0.0, 0.0), (1.0, 1.0, 0.25)),
                "diagcg_cf": ((6, 6, 6), (-0.5, -0.5, -0.5),
                              (0.5, 0.5, 0.5))}
#: L2(sol) and L2(err) per component after 11 float32 steps at 48^3 from
#: initial_state(), from the JAX package on the CPU (its XLA path, x64
#: off): quinoa_tpu.inciter.alecg.make_alecg on the bench_alecg.py mesh
#: (hilbert_element_reorder, first_touch_node_reorder, all boundary nodes
#: pinned), 11 step() calls, then quinoa_tpu.inciter.diagnostics.
JAX_L2 = {
    "alecg": {"l2sol": [0.15534241497516632],
              "l2err": [0.04810980707406998]},
    "alecg_cf": {"l2sol": [1.0, 0.2902412712574005, 0.2902684211730957,
                           0.05775976926088333, 15.08370590209961],
                 "l2err": [2.023221554736665e-07, 1.567408980918117e-05,
                           1.8303720935364254e-05, 2.188024609495187e-06,
                           0.00020845529797952622]},
    # quinoa_tpu.inciter.DiagCGSolver on the DIAGCG meshes (Hilbert
    # element and first-touch node order, all boundary nodes pinned,
    # make_cggeom in float32), 11 step() calls, then Diagnostics
    "diagcg": {"l2sol": [0.1609799712896347],
               "l2err": [0.035855941474437714]},
    "diagcg_cf": {"l2sol": [1.0, 0.2902284264564514, 0.29025334119796753,
                            0.05776010453701019, 15.083502769470215],
                  "l2err": [1.0135789096921144e-08, 1.8698386838877923e-07,
                            1.898314252457567e-07, 2.1582089004823501e-07,
                            8.071630190897849e-07]},
    # quinoa_tpu.inciter.dg.DGSolver on bench.py --dgp2's mesh and
    # configuration (build_dggeom in float32), 11 step() calls, then
    # DGDiagnostics
    "p2": {"l2sol": [1.0000001192092896, 0.5000001192092896,
                     0.5000001192092896, 6.455498464674747e-07,
                     15.255122184753418],
           "l2err": [2.340200495609679e-07, 1.983560423468589e-06,
                     1.974215820155223e-06, 6.455498464674747e-07,
                     7.111129889381118e-06]},
    # paths 12-15 (jax_reference_l2.py: the JAX package's DGSolver or
    # MultiMatSolver on the Hilbert-ordered 48^3 box, build_dggeom in
    # float32, 11 step() calls from initial_state(), then DGDiagnostics;
    # L2(sol) only is gated; t after 11 steps 5.932412e-3, 5.657528e-3,
    # 2.078030e-3 and 1.792473e-5)
    "p0": {"l2sol": [0.7100173234939575, 0.030790921300649643,
                     0.00250361324287951, 0.00250361324287951,
                     1.7688935995101929]},
    "mm_p0": {"l2sol": [0.7074539065361023, 0.7043488025665283,
                        0.7048956751823425, 0.0884728729724884,
                        0.030825775116682053, 0.002838805550709367,
                        0.0028388036880642176, 1.760284423828125,
                        0.1799716204404831]},
    "mm_p1": {"l2sol": [0.7071330547332764, 0.7064740657806396,
                        0.7065096497535706, 0.08839767426252365,
                        0.01432048249989748, 0.0007387085352092981,
                        0.0007394818239845335, 1.7656757831573486,
                        0.17788128554821014]},
    "mm_iface": {"l2sol": [0.5937113761901855, 0.1765287220478058,
                           0.7846028804779053, 5.937352180480957,
                           0.20502761006355286, 0.9112696647644043,
                           42.50482940673828, 42.50482940673828,
                           8.062566848821007e-06, 148724.765625,
                           44142.44140625, 196196.3125]},
    # paths 16-17, the same way (t after 11 steps 2.136693e-3 and
    # 5.974771e-6)
    "p1_lf": {"l2sol": [0.7114402055740356, 0.0130376685410738,
                        0.0006519562448374927, 0.0006519564194604754,
                        1.7733832597732544]},
    "mm_thinc": {"l2sol": [0.5889950394630432, 0.17312538623809814,
                           0.7810273766517639, 5.890181541442871,
                           0.20107600092887878, 0.9071171879768372,
                           42.29158020019531, 42.291534423828125,
                           0.09856325387954712, 147543.09375,
                           43291.5859375, 195302.15625]},
    # path 18, the same way (t after 11 steps 5.974771e-6)
    "mm_iface_p1": {"l2sol": [0.5889950394630432, 0.17312537133693695,
                              0.7810274362564087, 5.890181541442871,
                              0.20107600092887878, 0.9071171879768372,
                              42.29158401489258, 42.291534423828125,
                              0.09850376099348068, 147543.09375,
                              43291.5859375, 195302.140625]},
}
JAX_L2_RTOL = 1e-4
# Each L2 gate holds a component to rtol JAX_L2_RTOL plus L2_ULPS float32
# ulps of a scale, which L2_SCALE names per path:
# - "own" (the default): only L2(err) gets the ulps, of the component's own
#   L2(sol).  VorticalFlow is steady, so its L2(err) after 11 steps is
#   float32 round-off (2e-7 for rho = 1): the JAX package's own jitted and
#   eager evaluations of the manufactured source differ by 9.5e-7.
# - "largest": L2(sol) and L2(err) both get ulps of the largest L2(sol)
#   component (the energy's).  TaylorGreen's rho*w is zero in the exact
#   solution, so on the p2 path its L2(sol) (= its L2(err)) is round-off
#   of the pressure terms: 6.455e-7 after 11 steps in the JAX package's CPU
#   float32 run, 6.305e-7 in the port's own CPU float32 run.
# - "kind": L2(sol) and L2(err) both get ulps of the largest L2(sol) among
#   the component's kind (Euler: density, momentum, energy; multimat:
#   fractions, partial densities, momentum, material energies).  Transverse
#   momentum is round-off next to the axial one (the interface advection's
#   z momentum, 8.1e-6 against 42.5), and the energies (1.96e5 there) are
#   no scale for a fraction.
# L2(err) is gated where JAX_L2 holds it.
L2_ULPS = 8
# mm_thinc's z momentum is float32 round-off grown by THINC's flagged
# faces: 0.0986 in the JAX package's float32 run, 6.3e-11 in its float64
# run (jax_reference_l2.py --x64 mm_thinc).  Two JAX float32 runs from the
# same initial state perturbed below one ulp (--ulp-seed 1, 2) move it by
# 1.61e-4 and 1.43e-4, 32 and 28 ulps of the momentum kind's 42.29, while
# every other component moves by less than rtol 1e-4.  The gate allows
# twice the larger spread on that path.  mm_iface_p1 (the same advection
# on Dirichlet faces) is round-off there too: --ulp-seed 1 and 2 move its
# z momentum (0.0985) by 1.626e-4 and 1.418e-4, 32.25 and 28.14 ulps of
# 42.29, every other component by less than rtol 1e-4 (at most 9.2e-6
# relative); twice the larger spread, rounded up, is 65 ulps.
L2_ULPS_BY_PATH = {"mm_thinc": 64, "mm_iface_p1": 65}
L2_SCALE = {"p2": "largest", "p0": "kind", "mm_p0": "kind", "mm_p1": "kind",
            "mm_iface": "kind", "p1_lf": "kind", "mm_thinc": "kind",
            "mm_iface_p1": "kind"}
# The multimat cell-mean fractions after 11 steps: min alpha above
# -ALPHA_MIN_ULPS float32 ulps of 1 and |sum alpha - 1| below
# ALPHA_SUM_TOL.  The JAX package's own CPU float32 run of mm_p0 reaches
# min alpha = -1.564e-6 (13 ulps): the P0 scheme keeps a trace fraction
# (1e-12) positive only to round-off of the O(1) face sums, so no bound
# tighter than a few ulps holds; its sum error is 1.9e-6.
ALPHA_MIN_ULPS = 32
ALPHA_SUM_TOL = 1e-5
# FCT bounds SlotCyl to its initial [0, 0.6] only up to float32 round-off:
# the JAX package's own float32 run above leaves them by -2.644e-6 (44
# ulps of 0.6) and +1.55e-6 (26 ulps) within 11 steps.  The diagcg gate
# allows this many float32 ulps of the initial maximum on either side.
BOUNDS_ULPS = 64
#: the card's published peaks (H100 SXM at 700 W): device-memory bytes
#: per second, float32 operations per second outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# |kernel - plain| <= TOL * max|plain| per output.  Kernel and plain
# version evaluate the same expressions in the same order without fused
# multiply-adds, so they differ only by torch's own reduction order;
# the bounds leave room for a few ulp in the largest entries.
TOL = {"float32": 1e-5, "float64": 1e-12}
SOLVER_ATOL = 1e-11             # small-mesh solvers, card vs CPU, 2 steps
REPS = 7                        # timed repetitions (median)
L2_FLUSH_BYTES = 256 << 20      # filled before each timed call: > 50 MB L2
SPIN_CYCLES_PER_S = 2.0e9       # device_ms spin: the card's top SM clock
SPIN_MARGIN_S = 1e-4            # device_ms spin beyond 2x the host's time
NSTEPS = 10                     # timed steps of each path, after 1 warm-up

#: path 19, cli: the Sedov DG(P1) deck of the main path (p1) through the
#: port's inciter command at 48^3 in float32; run A checkpoints at step
#: CLI_RSFREQ and run B restarts from it
CLI_NSTEP = 11
CLI_RSFREQ = 6
CLI_DECK = """title "Sedov DG(P1), the main path"
inciter
  nstep {nstep}
  cfl 0.5
  scheme dgp1
  flux hllc
  limiter superbeep1
  compflow
    physics euler
    problem sedov_blastwave
    material gamma 1.4 end end
    bc_sym sideset 1 2 3 4 5 6 end end
  end
  diagnostics interval {interval} end
end
"""
#: the kernels a step of the cli path launches, 3 times each (p1's)
CLI_KERNELS = ("limit_vol", "face_wflux", "basis_accum")
#: one small deck per build_inciter branch, float64, CLI_SMALL_NSTEP
#: steps on a 6x6x4 box, card against CPU: (scheme, scheme line's
#: extra keywords, pde block, box lo, box hi, cfl)
CLI_SMALL_BOX = (6, 6, 4)
CLI_SMALL_NSTEP = 2
_SYM6 = "bc_sym sideset 1 2 3 4 5 6 end end"
_DIR6 = "bc_dirichlet sideset 1 2 3 4 5 6 end end"
_SOD = "bc_extrapolate sideset 1 2 end end bc_sym sideset 3 4 5 6 end end"
CLI_SMALL = {
    "diagcg_slotcyl": ("diagcg", "", "transport physics advection problem "
                       f"slot_cyl {_DIR6} end", (0.0, 0.0, 0.0),
                       (1.0, 1.0, 0.5), 0.8),
    "alecg_vorticalflow": ("alecg", "", "compflow physics euler problem "
                           "vortical_flow material gamma 1.66666666666667 end"
                           f" end {_DIR6} end", (-0.5, -0.5, -0.5),
                           (0.5, 0.5, 0.5), 0.5),
    "dg_sod": ("dg", "", f"compflow problem sod_shocktube {_SOD} end",
               (0.0, 0.0, 0.0), (1.0, 0.5, 0.5), 0.5),
    "pdg_sedov": ("pdg", "limiter superbeep1", "compflow problem "
                  f"sedov_blastwave {_SYM6} end", (0.0, 0.0, 0.0),
                  (0.6, 0.6, 0.4), 0.5),
    "p0p1_sedov": ("p0p1", "limiter superbeep1", "compflow problem "
                   f"sedov_blastwave {_SYM6} end", (0.0, 0.0, 0.0),
                   (0.6, 0.6, 0.4), 0.5),
    "dgp2_taylorgreen": ("dgp2", "", "compflow problem taylor_green material"
                         f" gamma 1.66666666666667 end end {_SYM6} end",
                         (0.0, 0.0, 0.0), (1.0, 1.0, 0.75), 0.5),
    "mm_dg_interface": ("dg", "", "multimat problem interface_advection "
                        f"nmat 3 {_DIR6} end", (0.0, 0.0, 0.0),
                        (1.0, 1.0, 0.5), 0.4),
    "mm_dgp1_sod_thinc": ("dgp1", "", "multimat problem sod_shocktube nmat 2"
                          f" intsharp 1 {_SOD} end", (0.0, 0.0, 0.0),
                          (1.0, 0.5, 0.5), 0.5),
}
#: the small deck also run as `python3 -m quinoa_tpu_torch inciter`
CLI_SUBPROCESS = "pdg_sedov"

#: paths 20-25: mesh refinement and tracers through the inciter command.
#: The DiagCG SlotCyl dtref deck of tests/test_amr.py:265-316 (jump error
#: on c, tol_refine 0.2), with the Dirichlet side sets {sides}: all six
#: in that test
AMR_SLOTCYL = """inciter
  nstep {nstep}
  cfl 0.8
  scheme diagcg
  transport
    physics advection problem slot_cyl ncomp 1 depvar c
    bc_dirichlet sideset {sides} end end
  end
  amr
    dtref true
    dtfreq {dtfreq}
    refvar c end
    error jump
    tol_refine 0.2
    {extra}
  end
  diagnostics interval 1 error l2 end
end
"""
#: CLI_DECK with an amr block (the Sedov DG(P1) main path)
AMR_SEDOV = CLI_DECK.replace("  diagnostics", "  amr {amr} end\n"
                             "  diagnostics")
#: path 20, amr_small: float64 decks on 6x6x2 boxes, card against CPU:
#: (deck, box lo, box hi).  Sedov's density jumps reach 0.0047 a step
#: whatever the cell size, so its dtref deck refines at tol_refine 0.005
#: (it=2) and coarsens back at tol_derefine 0.05 (it=4)
AMR_SMALL_BOX = (6, 6, 2)
_SLOTCYL_BOX = ((0.0, 0.0, 0.0), (1.0, 1.0, 0.25))
_SIX = "1 2 3 4 5 6"
_SEDOV_BOX = ((0.0, 0.0, 0.0), (0.6, 0.6, 0.2))
AMR_SMALL = {
    "diagcg_dtref": (AMR_SLOTCYL.format(nstep=12, dtfreq=4, extra="",
                                        sides=_SIX), *_SLOTCYL_BOX),
    "diagcg_dtref_maxlevels1": (AMR_SLOTCYL.format(
        nstep=12, dtfreq=4, extra="maxlevels 1", sides=_SIX),
        *_SLOTCYL_BOX),
    "diagcg_dtref_uniform": (AMR_SLOTCYL.format(
        nstep=9, dtfreq=4, extra="dtref_uniform true", sides=_SIX),
        *_SLOTCYL_BOX),
    "dgp1_dtref": (AMR_SEDOV.format(
        nstep=5, interval=1,
        amr="dtref true dtfreq 2 error jump tol_refine 0.005"),
        *_SEDOV_BOX),
    "dgp1_t0ref": (AMR_SEDOV.format(
        nstep=3, interval=1,
        amr="t0ref true initial uniform initial coords coordref x- 0.3 end "
            "initial uniform_derefine"), *_SEDOV_BOX),
}
#: path 21, amr_dg: the main path's deck at 48^3 with dtref every 3 steps
#: (the default maxlevels 4: the incremental cycle).  The default
#: tol_refine 0.2 never fires on Sedov in 11 steps (its density jumps
#: grow 0.0047 a step); 0.01 refines at it=3, coarsens back at it=6
#: (tol_derefine 0.05) and refines again at it=9 on 12^3 and 16^3 boxes
AMR_DG_DECK = AMR_SEDOV.format(
    nstep=CLI_NSTEP, interval=1,
    amr="dtref true dtfreq 3 error jump tol_refine 0.01")
#: path 22, amr_cg: bench_cg.py's DiagCG SlotCyl at 64^3, dtref every 4
#: steps, one level above the base mesh (maxlevels 1), Dirichlet on the
#: four sides where the solution is 0.  With the z faces pinned too, a
#: remesh interpolates the discontinuous pinned values at new z-face
#: midpoints and the pin then adds the analytic increment: both packages
#: reach -0.3 and 1.2 there (8^3 to 32^3 on the CPU), so the FCT bounds
#: gate runs with those faces free.  The incremental cycle's second event
#: refines the first one's level again (x7 a event at 24^3 on the CPU,
#: ~35M tets at 64^3): maxlevels 1 keeps two events to one level
_FOUR = "1 2 3 4"
AMR_CG_DECK = AMR_SLOTCYL.format(nstep=CLI_NSTEP, dtfreq=4,
                                 extra="maxlevels 1", sides=_FOUR)
#: launches of a DiagCGSolver build: its lumped mass (K11 once) and the
#: gathers of its Dirichlet mask and nodal volumes (K10 twice); a DGSolver
#: build launches nothing
DIAGCG_BUILD = {"node_gather": 2, "node_assemble": 1}
#: path 23, amr_remesh: bench_amr.py's remesh leg at 32^3
AMR_REMESH_N = 32
#: path 24, t0ref: the main path's deck on a 24^3 box refined 1:8 once,
#: as many tets as the 48^3 box
T0REF_N = 24
T0REF_DECK = AMR_SEDOV.format(nstep=CLI_NSTEP, interval=1,
                              amr="t0ref true initial uniform")
#: path 25, particles: tracers on the DiagCG SlotCyl 64^3 run (one event
#: of the incremental cycle, at it=6; amr_cg's faces) and on the Sedov P1
#: 48^3 run
NPAR = 100000
PARTICLE_DTFREQ = 6
#: float64 card-vs-CPU tracer steps and the position tolerance
PARTICLE_SMALL_STEPS = 5
PARTICLE_XP_ATOL = 1e-12

#: path 26, the walker: the coupled Position + Velocity + Dissipation
#: ensemble (tests/test_walker.py:178-199) at WALKER_NPAR in float32,
#: timed as bench_walker.py times it (one warm-up chunk, then
#: WALKER_CHUNKS chunks of WALKER_CHUNK steps, each followed by the
#: moments)
WALKER_NPAR = 1_000_000
WALKER_DT = 0.005
WALKER_CHUNK = 10
WALKER_CHUNKS = 5
WALKER_SEED = 11
#: the raw-draw gate's shape, and the card-vs-CPU runs of every system
WALKER_DRAW = (1_000_000, 7)
WALKER_NORMAL_ULPS = 2
#: log-gamma draws held bit for bit card against CPU, at these alphas
WALKER_GAMMA_N = 100_000
WALKER_GAMMA_ALPHAS = (0.3, 2.5)
WALKER_SMALL_NPAR = 4096
WALKER_SMALL_STEPS = 5
WALKER_RTOL = 1e-12
WALKER_ATOL = 1e-14
#: path 27, rngtest: the seed of the command and of the card-vs-CPU
#: SmallCrush, the p-value tolerance (the draws are bit-identical), the
#: RANDU subset (tests/test_rngtest.py:59-60) and the seed of the scomp
#: entries (the command's default)
RNG_SEED = 7
RNG_RTOL = 1e-12
RANDU_SUBSET = ("gap", "max_of_t", "weight_distrib", "random_walk",
                "ks_uniform", "hamming_indep")
SCOMP_SEED = 0
#: path 28, meshconv: the box, the pieces of its split and the coordinate
#: tolerance of the text formats (16 significant digits of coordinates in
#: [0, 1])
CONV_N = 48
CONV_PIECES = 4
CONV_COORD_ATOL = 1e-15
#: the walker command's inline deck (float64, card against CPU)
WALKER_DECK = """title "walker smoke"
walker
  term 0.05  dt 0.005  npar 20000
  rngs r123_threefry seed 4 end end
  position
    depvar x  velocity u  init jointgaussian
    icgaussian gaussian 0.0 1.0 end gaussian 0.0 1.0 end
               gaussian 0.0 1.0 end end
  end
  velocity
    depvar u  dissipation o  init jointgaussian
    icgaussian gaussian 0.0 0.5 end gaussian 0.0 0.5 end
               gaussian 0.0 0.5 end end
  end
  dissipation
    depvar o  velocity u  init jointgaussian
    icgaussian gaussian 1.0 0.01 end end
  end
  statistics interval 2 <U1> <O> <u1u1> <u1u2> <x1u1> <o1o1> end
  pdfs interval 10 filetype txt f2( u1 u2 : 0.1 0.1 ) end
end
"""

KERNELS = {
    "limit_vol": ("quinoa_tpu_torch/csrc/limit_vol.cu",
                  "quinoa_tpu/ops/nbr_bounds.py:541"),
    "nbr_bounds": ("quinoa_tpu_torch/csrc/nbr_bounds.cu",
                   "quinoa_tpu/ops/nbr_bounds.py:258"),
    "face_gather": ("quinoa_tpu_torch/csrc/face_gather.cu",
                    "quinoa_tpu/ops/face_accum.py:698"),
    "face_accum": ("quinoa_tpu_torch/csrc/face_accum.cu",
                   "quinoa_tpu/ops/face_accum.py:644"),
    "alecg_vol": ("quinoa_tpu_torch/csrc/alecg_vol.cu",
                  "quinoa_tpu/ops/alecg_fused.py:259"),
    "alecg_vol_cf": ("quinoa_tpu_torch/csrc/alecg_vol.cu",
                     "quinoa_tpu/ops/alecg_fused.py:165"),
    "alecg_edge": ("quinoa_tpu_torch/csrc/alecg_edge.cu",
                   "quinoa_tpu/ops/alecg_fused.py:303"),
    "alecg_edge_cf": ("quinoa_tpu_torch/csrc/alecg_edge.cu",
                      "quinoa_tpu/ops/alecg_fused.py:214"),
    "cg_assemble": ("quinoa_tpu_torch/csrc/cg_assemble.cu",
                    "quinoa_tpu/ops/window_kernels.py:148"),
    "node_gather": ("quinoa_tpu_torch/csrc/node_gather.cu",
                    "quinoa_tpu/ops/node_window.py:261"),
    "node_assemble": ("quinoa_tpu_torch/csrc/node_assemble.cu",
                      "quinoa_tpu/ops/node_window.py:347"),
    # B11 (p2's single-stream pass); on the other paths B2-B5 (NEARFAR)
    "face_wflux": ("quinoa_tpu_torch/csrc/face_wflux.cu",
                   "quinoa_tpu/ops/face_fused.py:333"),
    "basis_accum": ("quinoa_tpu_torch/csrc/basis_accum.cu",
                    "quinoa_tpu/ops/face_fused.py:253"),
    "mm_face_wflux": ("quinoa_tpu_torch/csrc/mm_face_wflux.cu",
                      "quinoa_tpu/ops/face_fused.py:762"),
    # the Lax-Friedrichs flavour of K12 and the THINC flavour of K14, each
    # replacing the TPU near/far face pass B2-B5 tracing that physics
    "face_wflux_lf": ("quinoa_tpu_torch/csrc/face_wflux.cu",
                      "quinoa_tpu/ops/face_fused.py:762"),
    "mm_face_wflux_thinc": ("quinoa_tpu_torch/csrc/mm_face_wflux.cu",
                            "quinoa_tpu/ops/face_fused.py:762"),
}
#: the kernel instances of the paths, listed in the kernels line beside
#: the kernels above: (entry, launch counter, path); the source and the
#: replaced TPU kernel are KERNELS[counter]'s, except that on every DG path
#: but p2 the TPU runs the near/far kernels B2-B5 (NEARFAR)
INSTANCES = (
    ("face_wflux (K=4)", "face_wflux", "p1"),
    ("basis_accum (R=5, K=4)", "basis_accum", "p1"),
    ("face_wflux (K=10)", "face_wflux", "p2"),
    ("basis_accum (R=5, K=10)", "basis_accum", "p2"),
    ("face_wflux (K=1)", "face_wflux", "p0"),
    ("basis_accum (R=5, K=1)", "basis_accum", "p0"),
    ("basis_accum (R=16, K=1)", "basis_accum", "mm_p0"),
    ("mm_face_wflux (K=4)", "mm_face_wflux", "mm_p1"),
    ("basis_accum (R=16, K=4)", "basis_accum", "mm_p1"),
    ("nbr_bounds (C=9, K=4)", "nbr_bounds", "mm_p1"),
    ("face_gather (R=12)", "face_gather", "mm_iface"),
    ("face_accum (R=22)", "face_accum", "mm_iface"),
    ("face_wflux LF (K=4)", "face_wflux_lf", "p1_lf"),
    ("mm_face_wflux THINC (nmat 3, K=4)", "mm_face_wflux_thinc", "mm_thinc"),
    ("basis_accum (R=22, K=4)", "basis_accum", "mm_thinc"),
    ("nbr_bounds (C=12, K=4)", "nbr_bounds", "mm_thinc"),
    ("face_gather (R=108)", "face_gather", "mm_iface_p1"),
    ("face_gather (R=48)", "face_gather", "mm_iface_p1"),
    ("face_accum (R=88)", "face_accum", "mm_iface_p1"),
    ("cg_assemble (R=5)", "cg_assemble", "alecg_cf"),
    ("node_assemble P+Q (R=2+2)", "node_assemble", "diagcg"),
    ("node_assemble A (R=1)", "node_assemble", "diagcg"),
    ("node_assemble (R=10)", "node_assemble", "diagcg_cf"),
    ("node_assemble P+Q (R=10+10)", "node_assemble", "diagcg_cf"),
    ("node_assemble A (R=5)", "node_assemble", "diagcg_cf"),
)
NEARFAR = {"face_wflux": "quinoa_tpu/ops/face_fused.py:762",
           "basis_accum": "quinoa_tpu/ops/face_fused.py:839"}
#: paths 12-18: (problem, ndof, cfl); faces SOD_BC, Dirichlet on all six
#: sides for mm_iface and mm_iface_p1, extrapolate on all six for mm_thinc
MM = {"p0": ("sod", 1, 0.5), "mm_p0": ("mm_sod", 1, 0.5),
      "mm_p1": ("mm_sod", 4, 0.5), "mm_iface": ("mm_iface", 1, 0.4),
      "p1_lf": ("sod", 4, 0.5), "mm_thinc": ("mm_iface", 4, 0.4),
      "mm_iface_p1": ("mm_iface", 4, 0.4)}
#: the Euler paths among them (the others are multimat)
EULER = ("p0", "p1_lf")
MM_SMALL = (8, 3, 2)            # float64 card-vs-CPU and kernel meshes
#: launches per step of each path; every other kernel must launch 0 times
PATHS = {
    "p1": {"limit_vol": 3, "face_wflux": 3, "basis_accum": 3},
    "pdg": {"nbr_bounds": 3, "face_wflux": 3, "basis_accum": 3},
    "hump": {"face_gather": 8, "face_accum": 3},
    "alecg": {"alecg_vol": 3, "alecg_edge": 3, "cg_assemble": 3},
    "alecg_cf": {"alecg_vol_cf": 3, "alecg_edge_cf": 3, "cg_assemble": 3},
    "diagcg": {"node_gather": 3, "node_assemble": 3},
    "diagcg_cf": {"node_gather": 3, "node_assemble": 3},
    "p2": {"face_wflux": 3, "basis_accum": 3},
    "p0": {"face_wflux": 3, "basis_accum": 3},
    "mm_p0": {"mm_face_wflux": 3, "basis_accum": 3},
    "mm_p1": {"nbr_bounds": 3, "mm_face_wflux": 3, "basis_accum": 3},
    "mm_iface": {"face_gather": 8, "face_accum": 3},
    "p1_lf": {"limit_vol": 3, "face_wflux_lf": 3, "basis_accum": 3},
    "mm_thinc": {"nbr_bounds": 3, "mm_face_wflux_thinc": 3,
                 "basis_accum": 3},
    # K5: el and er of each stage's rhs (108 rows) and of the stage-0 dt
    # sweep (48 rows)
    "mm_iface_p1": {"nbr_bounds": 3, "face_gather": 8, "face_accum": 3},
    # the walker's draws and steps are torch ops: no hand kernel
    "walker": {},
}
#: the path whose launches the kernels line reports for each kernel
MAIN_PATH = {"limit_vol": "p1", "nbr_bounds": "pdg",
             "face_gather": "hump", "face_accum": "hump", "alecg_vol": "alecg",
             "alecg_edge": "alecg", "cg_assemble": "alecg",
             "alecg_vol_cf": "alecg_cf", "alecg_edge_cf": "alecg_cf",
             "node_gather": "diagcg", "node_assemble": "diagcg",
             "face_wflux": "p1", "basis_accum": "p1",
             "mm_face_wflux": "mm_p0", "face_wflux_lf": "p1_lf",
             "mm_face_wflux_thinc": "mm_thinc"}
#: floating-point operations a kernel does per entity (element, face,
#: edge or node; per row where it says so), counted from its source and
#: rounded up.  Every kernel here is bound by bytes by a wide margin.
OPS = {"limit_vol": 2000, "nbr_bounds_row": 8, "face_gather": 0,
       "face_accum_row": 4, "alecg_vol_row": 40, "alecg_vol_cf": 400,
       "alecg_edge_row": 3, "alecg_edge_cf": 70, "cg_assemble_slot": 1,
       "node_gather": 0, "node_assemble_slot": 1,
       # K12 per face and K13 per element at K modes (K13 also by its
       # rows R); K14 per face by (nmat, K)
       "face_wflux": {1: 300, 4: 1000, 10: 3500},
       "basis_accum": {(5, 1): 100, (5, 4): 700, (5, 10): 5000,
                       (16, 1): 300, (16, 4): 2000, (22, 1): 400,
                       (22, 4): 2800},
       # the THINC flavour adds two primitive evaluations and ~40 flops a
       # material and side to each of the 3 points
       "mm_face_wflux": {(2, 1): 400, (2, 4): 1500, (3, 1): 500,
                         (3, 4): 2000},
       "mm_face_wflux_thinc": {(2, 4): 2500, (3, 4): 3500}}


def tpu_precision_initial_u(solver, torch):
    """The initial state (C*K, E) the committed known-good L2 comes from.

    The known-good was harvested on a TPU, where XLA's default matmul
    precision rounds both operands of dg_initialize's two einsums (face
    coordinates and the L2 projection) to bfloat16 and accumulates in
    float32.  That shifts the projected state by up to ~1e-3 (the 14
    rounded Gauss weights sum to 1.000977), which the 5e-4 gate resolves.
    This reproduces the rounding: products of bfloat16 values are exact in
    float32.  The port's own initial_state() projects in full float32."""
    g, tb = solver.geom, solver.geom.tables
    f32 = dict(dtype=torch.float32, device=g.device)

    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)

    xi = torch.as_tensor(tb["xi_init"].T, **f32)
    gp = g.node0[:, None, :] + torch.einsum("ime,mg->ige", bf16(g.Jmat),
                                            bf16(xi))
    f = solver.system.initialize(gp, 0.0)
    wB = torch.as_tensor(tb["w_init"][:, None] * tb["B_init"], **f32)
    proj = torch.einsum("gk,cge->cke", bf16(wB), bf16(f))
    mn = torch.as_tensor(tb["mnorm"], **f32)
    return (proj / mn[None, :, None]).reshape(-1, g.nelem).contiguous()


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def box_geom(n, bc_code, dtype, device):
    """DG(P1) geometry of a Hilbert-ordered box with one BC on all six
    sides: the unit cube at 48^3, 0.1 per cell on the Sedov mesh, and
    the GaussHump box of tests/test_dg.py."""
    from quinoa_tpu_torch.mesh import box_tet_mesh, hilbert_element_reorder
    from quinoa_tpu_torch.pde.dg import build_dggeom

    nx, ny, nz = n
    if n == (N_BIG,) * 3:
        hi = (1.0, 1.0, 1.0)
    elif n == HUMP_SMALL:
        hi = (1.0, 1.0, 0.2)
    else:
        hi = (0.1 * nx, 0.1 * ny, 0.1 * nz)
    mesh, _ = hilbert_element_reorder(box_tet_mesh(nx, ny, nz, hi=hi))
    bc = {i: bc_code for i in range(1, 7)}
    return build_dggeom(mesh, ndof=4, bc_sidesets=bc, dtype=dtype,
                        device=device)


def perturbed_state(E, seed, K=4):
    """Physical Sedov-like modal state with perturbed higher dofs (the
    construction of tests/test_dg.py's fused-pass parity test)."""
    rng = np.random.default_rng(seed)
    U0 = np.zeros((5 * K, E))
    U0[0] = 1.0 + 0.05 * rng.random(E)
    U0[4 * K] = 2.5 + 0.05 * rng.random(E)
    U0[K] = 0.1 * rng.random(E)
    for ck in range(5 * K):
        if ck % K:
            U0[ck] = 0.01 * rng.random(E)
    return U0


def call_ms(torch, fn):
    """Median CUDA-event time in ms of one fn() on an idle card, after one
    warm-up call: host and device.  The card idles after each synchronize,
    so the window also holds the host's work before the first kernel is
    enqueued (a ctypes wrapper's checks, allocation and launch, some
    0.03-0.06 ms): what one launch costs a host-bound path, not the
    kernel's time (device_ms)."""
    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fns, reps=REPS):
    """Device time of each fn in fns, taken in turns and from a cold L2:
    [(median, min, max) ms] over reps calls each.

    Each call is timed by CUDA events on a card that is kept busy while
    the host enqueues it: the L2_FLUSH_BYTES byte buffer is filled
    (evicting the 50 MB L2, so no input is served from a warm cache), a
    spin kernel holds the stream for twice the host's time to enqueue fn
    (measured on a warm-up call) plus SPIN_MARGIN_S, then event a, fn(),
    event b.  When b has been enqueued the host checks that the card has
    not reached a yet: then every launch of fn was queued before the first
    ran, and a to b is the device's time for fn alone (its kernels back to
    back), with neither the host nor the flush in it.  Otherwise the
    repetition is taken again with a spin twice as long (a call that
    synchronises, or enqueues more launches than the card's queue holds,
    cannot be timed so and raises).  The calls go in turns, fns in order
    and then in reverse (A B B A for a kernel and its one-call yardstick),
    after two warm-up calls each."""
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    host = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    order = []
    for r in range(reps):
        order += list(range(len(fns)))[::1 if r % 2 == 0 else -1]
    times = [[] for _ in fns]
    for i in order:
        spin = 2.0 * host[i] + SPIN_MARGIN_S
        while True:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            scratch.fill_(1)
            torch.cuda._sleep(int(spin * SPIN_CYCLES_PER_S))
            a.record()
            fns[i]()
            b.record()
            early = not a.query()
            torch.cuda.synchronize()
            if early:
                break
            spin *= 2.0
            if spin > 1.0:
                raise AssertionError(
                    "device_ms: the host does not finish enqueueing a call "
                    "within 1 s of spin (a host synchronisation, or more "
                    "launches than the launch queue holds)")
        times[i].append(a.elapsed_time(b))
    return [(statistics.median(t), min(t), max(t)) for t in times]


def compare(name, got, want, dtype_name):
    """max |got - want| over the outputs; raises past the tolerance."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: kernel gives {g.dtype} "
                                 f"{tuple(g.shape)}, plain {w.dtype} "
                                 f"{tuple(w.shape)}")
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        if not err <= TOL[dtype_name] * scale:
            raise AssertionError(
                f"{name} ({dtype_name}): max|kernel - plain| = {err:.3e} "
                f"exceeds {TOL[dtype_name]:g} * {scale:.3e}")
        worst = max(worst, err)
    return worst


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bit_identical(got, want):
    """Bit for bit, a NaN matching a NaN (+0 and -0 compare equal)."""
    return all(g.shape == w.shape and g.dtype == w.dtype and bool(
        ((g == w) | (g.isnan() & w.isnan())).all()) for g, w in zip(got, want))


def measure(torch, name, label, kf, pf, inputs, ops, dtype_name, timed,
            library=None, bitwise=False):
    """kf() (the kernel) against pf() (its plain version) on the same
    inputs; when timed, the device times (device_ms, in turns) of the
    kernel and of library() (one PyTorch call computing the same function,
    or None), the host-inclusive call_ms of the kernel and of the plain
    version (hundreds of launches, more than the card's launch queue
    holds: device_ms cannot keep the host out of it), and the bound: the
    larger of the bytes of the inputs (each read once) and outputs (each
    written once) over HBM_BYTES_PER_S and ops over F32_OPS_PER_S.
    With bitwise the kernel must equal the plain version bit for bit (a
    NaN matching a NaN; max_abs_err is then 0), else agree to TOL.
    Returns {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms,
    call_ms}."""
    got, want = kf(), pf()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    if bitwise:
        if not bit_identical(got, want):
            raise AssertionError(f"{name} ({dtype_name}): the kernel is not "
                                 "bit-identical to the plain version")
        nans = sum(int(w.isnan().sum()) for w in want)
        err, how = 0.0, f"bit-identical, {nans} NaN matched"
    else:
        err = compare(name, got, want, dtype_name)
        how = f"tol {TOL[dtype_name]:g} * max|plain|"
    rec = {"max_abs_err": err, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None, "library_ms": None,
           "call_ms": None}
    msg = (f"{name} {dtype_name} {label}: max|kernel-plain|="
           f"{rec['max_abs_err']:.3e} ({how})")
    if timed:
        b = nbytes(*inputs, *got)
        t_bytes, t_ops = 1e3 * b / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
        times = device_ms(torch, [kf] if library is None else [kf, library])
        k, lib = times[0], times[1] if library else None
        rec.update(ms=k[0], plain_ms=call_ms(torch, pf),
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=lib and lib[0], call_ms=call_ms(torch, kf))
        msg += (f" kernel {spread(k)}"
                + ("" if lib is None else f", one torch call {spread(lib)}")
                + f" (device, {REPS} in turns, cold L2); one call of the "
                f"kernel {rec['call_ms']:.4f} ms, of the plain version "
                f"{rec['plain_ms']:.4f} ms (host + device); bound "
                f"{rec['bound_ms']:.4f} ms ({b} bytes, {ops:.4g} ops: "
                f"{rec['bound_by']})")
    phase("kernels", msg)
    return rec


def spread(t):
    """'median ms [min-max]' of a device_ms entry."""
    return f"{t[0]:.4f} ms [{t[1]:.4f}-{t[2]:.4f}]"


def kernel_checks(torch, geom, system, U, dtype_name, timed):
    """K1 on the Sedov state U, then K12 + K13 on its limited state and
    volume term (p1's face pass), each against its plain version bit for
    bit; returns {name: record} (times only when timed)."""
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.ops.nbr_bounds import limit_vol_plain

    g = geom
    vole = g.vol * g.emask

    def k1():
        return kernels.limit_vol(U, g.esuelT, g.jacInv, vole, g.ktab, 2.0,
                                 system.eos)

    def p1():
        return limit_vol_plain(system, g, U)

    out = {"limit_vol": measure(
        torch, "limit_vol", f"E={g.nelem}", k1, p1,
        (U, g.esuelT, g.jacInv, vole, g.ktab), OPS["limit_vol"] * g.nelem,
        dtype_name, timed, bitwise=True)}
    out.update(single_stream_checks(torch, g, system, *p1(), dtype_name,
                                    timed))
    return out


def p2_geom(n, dtype, device):
    """DG(P2) geometry of bench.py --dgp2: a Hilbert-ordered box with
    symmetry on all six sides, the unit cube at 32^3 (nz/nx high on the
    small box)."""
    from quinoa_tpu_torch.mesh import box_tet_mesh, hilbert_element_reorder
    from quinoa_tpu_torch.pde.dg import BC_SYMMETRY, build_dggeom

    nx, ny, nz = n
    mesh, _ = hilbert_element_reorder(box_tet_mesh(nx, ny, nz,
                                                   hi=(1.0, 1.0, nz / nx)))
    return build_dggeom(mesh, ndof=10,
                        bc_sidesets={i: BC_SYMMETRY for i in range(1, 7)},
                        dtype=dtype, device=device)


def single_stream_checks(torch, geom, system, U, rv, dtype_name, timed):
    """K12 (the flavour of system.riemann_flux) and K13 against their plain
    versions bit for bit on the state U (C*K, E) of geom (P0, P1 or P2)
    with the volume term rv, then both as the step calls them; returns
    {name: record} (times only when timed)."""
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.ops.face_fused import (basis_accum_plain,
                                                 face_wflux_plain,
                                                 fused_face_pass)

    g, K = geom, geom.ndof

    def k12():
        return kernels.face_wflux(U, g.el, g.er, g.fn, g.farea, g.fmask,
                                  g.xi_l, g.xi_r, g.bctype, g.w_face,
                                  system.eos, system.riemann_flux)

    def p12():
        return face_wflux_plain(system, g, U)

    wfl, mx = p12()

    def k13():
        return kernels.basis_accum(wfl, mx, g.fose, g.fsideR, g.xi_l,
                                   g.xi_r, K, rv)

    def p13():
        return basis_accum_plain(g, wfl, mx, rv)

    E, F = g.nelem, g.nface
    # at P0 the basis is 1: neither kernel reads the Gauss coordinates
    xi = (g.xi_l, g.xi_r) if K > 1 else ()
    cases = (
        ("face_wflux", k12, p12, (U, g.el, g.er, g.fn, g.farea, g.fmask,
                                  *xi, g.bctype, g.w_face),
         OPS["face_wflux"][K] * F),
        ("basis_accum", k13, p13, tuple(
            t for t in (wfl, mx, g.fose, g.fsideR, *xi, rv) if t is not None),
         OPS["basis_accum"][5, K] * E),
    )
    label = f"{system.riemann_flux} K={K} E={E} F={F}"
    out = {name: measure(torch, name, label, kf, pf, inputs, ops, dtype_name,
                         timed, bitwise=True)
           for name, kf, pf, inputs, ops in cases}
    got = fused_face_pass(system, g, U, vol_rhs=rv)
    want = basis_accum_plain(g, *face_wflux_plain(system, g, U), rv)
    if not bit_identical(got, want):
        raise AssertionError(f"face pass K12+K13 {label} ({dtype_name}): "
                             "not bit-identical to the plain versions")
    phase("kernels", f"K12+K13 {label} {dtype_name}: bit-identical to the "
          "plain versions; no single PyTorch call computes either kernel's "
          "function")
    return out


def mm_geom(name, n, dtype, device):
    """DG geometry of path 12-18 `name` on a Hilbert-ordered box of n =
    (nx, ny, nz) cells spanning (1, ny/nx, nz/nx): the Sod tube's faces
    (extrapolate on the x faces, symmetry on the others), Dirichlet on all
    six sides for mm_iface and mm_iface_p1, extrapolate on all six for
    mm_thinc."""
    from quinoa_tpu_torch.mesh import box_tet_mesh, hilbert_element_reorder
    from quinoa_tpu_torch.pde.dg import (BC_DIRICHLET, BC_EXTRAPOLATE,
                                         BC_SYMMETRY, build_dggeom)

    nx, ny, nz = n
    mesh, _ = hilbert_element_reorder(box_tet_mesh(
        nx, ny, nz, hi=(1.0, ny / nx, nz / nx)))
    if name in ("mm_iface", "mm_iface_p1"):
        bc = {i: BC_DIRICHLET for i in range(1, 7)}
    elif name == "mm_thinc":
        bc = {i: BC_EXTRAPOLATE for i in range(1, 7)}
    else:
        bc = {1: BC_EXTRAPOLATE, 2: BC_EXTRAPOLATE,
              **{i: BC_SYMMETRY for i in range(3, 7)}}
    return build_dggeom(mesh, ndof=MM[name][1], bc_sidesets=bc, dtype=dtype,
                        device=device)


def mm_solver(name, geom, nmat=None):
    """The solver of path 12-18 `name` on geom; nmat (2 or 3) makes a
    multimat path's problem the interface advection with that many
    materials."""
    from quinoa_tpu_torch.inciter.dg import DGSolver
    from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow
    from quinoa_tpu_torch.pde.multimat import MultiMatSolver, MultiMatSystem
    from quinoa_tpu_torch.pde.problems import (MMInterfaceAdvection,
                                               MMSodShocktube, SodShocktube)

    _, ndof, cfl = MM[name]
    limiter = "superbeep1" if ndof == 4 else None
    if name in EULER:
        flux = "laxfriedrichs" if name == "p1_lf" else "hllc"
        return DGSolver(DGCompFlow(SodShocktube(), riemann_flux=flux), geom,
                        cfl=cfl, limiter=limiter)
    problem = (MMInterfaceAdvection(nmat=nmat or 3)
               if MM[name][0] == "mm_iface" or nmat else MMSodShocktube())
    thinc = name in ("mm_thinc", "mm_iface_p1")
    return MultiMatSolver(MultiMatSystem(problem, intsharp=thinc),
                          geom, cfl=cfl, limiter=limiter)


def mm_perturbed(torch, solver, seed=19):
    """The multimat solver's initial state with its partial densities and
    energies scaled by up to 2% and a momentum of 0.1 rho randn added to
    the means (the fractions untouched), then limited (at P1).  With THINC
    (the P1 interface advection, whose trace materials' face values cancel
    to round-off between mean and slopes, so that scaling single modes
    makes inadmissible face states) each element's slopes are instead
    scaled by one factor in [0.8, 1]: every face state stays a convex
    combination of an admissible face state and the cell mean."""
    sy, g = solver.system, solver.geom
    C, K, nmat = sy.ncomp, g.ndof, sy.nmat
    u = solver.initial_state().u.reshape(C, K, -1).clone()
    gen = torch.Generator(device=u.device).manual_seed(seed)
    if sy.intsharp:
        r = torch.rand(u.shape[2], generator=gen, device=u.device,
                       dtype=u.dtype)
        u[:, 1:] = u[:, 1:] * (1.0 - 0.2 * r)
    else:
        r = torch.rand(u[nmat:].shape, generator=gen, device=u.device,
                       dtype=u.dtype)
        u[nmat:] = u[nmat:] * (1.0 + 0.02 * r)
    rho = u[nmat:2 * nmat, 0].sum(dim=0)
    u[2 * nmat:2 * nmat + 3, 0] += 0.1 * rho * torch.randn(
        (3, u.shape[2]), generator=gen, device=u.device, dtype=u.dtype)
    return solver._limit(u.reshape(C * K, -1).contiguous())


def thinc_flag_share(geom, carriers):
    """(flagged, total): the real face points at which some material's
    THINC flag is set on either side (the flags are cell constants, so a
    face's G points share them; a boundary face's ghost has its left
    side's)."""
    flag = (carriers[5::8] > 0.5).any(dim=0)              # (E,)
    el, er = geom.el.long(), geom.er.long()
    real = geom.fmask > 0
    G = geom.xi_l.shape[1]
    hit = (flag[el] | flag[er]) & real
    return G * int(hit.sum()), G * int(real.sum())


def sod_perturbed(torch, solver, seed=31):
    """The Euler Sod solver's initial state with a momentum of 0.1 rho
    randn added to the means and, at P1 and above, every higher mode set
    to up to 1% of its component's mean magnitude (seeded rand)."""
    g = solver.geom
    K, E = g.ndof, g.nelem
    u = solver.initial_state().u.reshape(5, K, E).clone()
    gen = torch.Generator(device=u.device).manual_seed(seed)
    u[1:4, 0] += 0.1 * u[0, 0] * torch.randn((3, E), generator=gen,
                                              device=u.device, dtype=u.dtype)
    if K > 1:
        u[:, 1:] = 0.01 * u[:, :1].abs() * torch.rand(
            (5, K - 1, E), generator=gen, device=u.device, dtype=u.dtype)
    return u.reshape(5 * K, E).contiguous()


def mm_kernel_checks(torch, solver, dtype_name, timed):
    """K14 (its THINC flavour for a solver with intsharp, after printing
    the share of THINC-flagged face points, which must not be 0) and K13
    (at K14's R rows) against their plain versions on mm_perturbed's state
    of the multimat solver, then both as mm_face_pass; returns {name:
    record} (times only when timed)."""
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.ops.face_fused import (basis_accum_plain,
                                                 mm_face_pass,
                                                 mm_face_wflux_plain)

    sy, g = solver.system, solver.geom
    K, nmat, R = g.ndof, sy.nmat, sy.nrows
    U = mm_perturbed(torch, solver)
    thinc = sy.intsharp and K == 4
    X = sy.thinc_carriers(g, U.reshape(sy.ncomp, K, -1)) if thinc else None
    if thinc:
        hit, total = thinc_flag_share(g, X)
        phase("kernels", f"THINC nmat={nmat} E={g.nelem} {dtype_name}: "
              f"flagged face points {hit} of {total} ({hit / total:.4f})")
        if hit == 0:
            raise AssertionError("THINC: no face point is flagged, the tanh "
                                 "branch is not exercised")

    def k14():
        return kernels.mm_face_wflux(U, g.el, g.er, g.fn, g.farea, g.fmask,
                                     g.xi_l, g.xi_r, g.bctype, g.w_face,
                                     sy.eos, X, sy.thinc_beta)

    def p14():
        return mm_face_wflux_plain(sy, g, U, X)

    wfl, mx = p14()

    def k13():
        return kernels.basis_accum(wfl, mx, g.fose, g.fsideR, g.xi_l,
                                   g.xi_r, K)

    def p13():
        return basis_accum_plain(g, wfl, mx)

    E, F = g.nelem, g.nface
    xi = (g.xi_l, g.xi_r) if K > 1 else ()
    k14_name = "mm_face_wflux_thinc" if thinc else "mm_face_wflux"
    cases = (
        (k14_name, k14, p14, (U, g.el, g.er, g.fn, g.farea, g.fmask, *xi,
                              g.bctype, g.w_face, *([X] if thinc else [])),
         OPS[k14_name][nmat, K] * F),
        ("basis_accum", k13, p13, (wfl, mx, g.fose, g.fsideR, *xi),
         OPS["basis_accum"][R, K] * E),
    )
    label = f"nmat={nmat} K={K} R={R} E={E} F={F}"
    out = {name: measure(torch, name, label, kf, pf, inputs, ops, dtype_name,
                         timed)
           for name, kf, pf, inputs, ops in cases}
    err = compare("face pass K14+K13", mm_face_pass(sy, g, U, X),
                  basis_accum_plain(g, *mm_face_wflux_plain(sy, g, U, X)),
                  dtype_name)
    phase("kernels", f"K14+K13 {label}{' THINC' if thinc else ''} "
          f"{dtype_name}: max|kernel-plain|={err:.3e} (tol "
          f"{TOL[dtype_name]:g} * max|plain|); no single PyTorch call "
          "computes AUSM+up with the riemannDeriv rows")
    return out


def nbr_bounds_check(torch, solver, dtype_name, timed):
    """K4 against its plain version on mm_perturbed's state of the
    multimat solver (all C = 3 nmat + 3 components); returns its
    record."""
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.ops.nbr_bounds import neighbor_mean_bounds_plain

    g, C, K = solver.geom, solver.system.ncomp, solver.geom.ndof
    U = mm_perturbed(torch, solver)
    return measure(torch, "nbr_bounds", f"E={g.nelem} C={C} K={K}",
                   lambda: kernels.nbr_bounds(U, g.esuelT, C, K),
                   lambda: neighbor_mean_bounds_plain(g, U[::K]),
                   (U[::K], g.esuelT), OPS["nbr_bounds_row"] * C * g.nelem,
                   dtype_name, timed)


def face_gp_kernel_checks(torch, geom, U, C, fgeom, Uf, cL, cR, base,
                          dtype_name, timed):
    """K4 on the C-component state U (C*K, E) of geom, K5 on the rows Uf of
    fgeom (left and right states), and K6 on its face rows cL, cR (R, F)
    onto base (or zero), against their plain versions; returns {name:
    record} of K4, K5 at el and K6 (times only when timed)."""
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.ops.face_accum import (accumulate_faces_plain,
                                                 face_gather_plain)
    from quinoa_tpu_torch.ops.nbr_bounds import neighbor_mean_bounds_plain

    K = geom.ndof
    R, Rf = cL.shape[0], Uf.shape[0]
    # one-call yardsticks: index_select for the gather; index_add_ of every
    # face's left row to el and every interior face's right row to er
    el, er = fgeom.el.long(), fgeom.er.long()
    inner = el != er
    acc = (torch.zeros((R, fgeom.nelem), dtype=cL.dtype, device=cL.device)
           if base is None else base.clone())
    src = torch.cat([cL, cR[:, inner]], dim=1)
    idx = torch.cat([el, er[inner]])
    E, F = fgeom.nelem, fgeom.nface
    cases = (
        ("nbr_bounds", f"E={geom.nelem} C={C} K={K}",
         lambda: kernels.nbr_bounds(U, geom.esuelT, C, K),
         lambda: neighbor_mean_bounds_plain(geom, U[::K]),
         (U[::K], geom.esuelT), OPS["nbr_bounds_row"] * C * geom.nelem,
         None),
        ("face_gather", f"E={E} F={F} rows={Rf}",
         lambda: kernels.face_gather(Uf, fgeom.el),
         lambda: face_gather_plain(Uf, fgeom.el), (Uf, fgeom.el), 0,
         lambda: torch.index_select(Uf, 1, fgeom.el)),
        ("face_accum", f"E={E} F={F} rows={R}",
         lambda: kernels.face_accum(cL, cR, fgeom.fose, fgeom.fsideR, base),
         lambda: accumulate_faces_plain(fgeom, cL, cR, base),
         tuple(t for t in (cL, cR, fgeom.fose, fgeom.fsideR, base)
               if t is not None),
         OPS["face_accum_row"] * R * E, lambda: acc.index_add_(1, idx, src)),
    )
    out = {name: measure(torch, name, label, kf, pf, inputs, ops, dtype_name,
                         timed, library)
           for name, label, kf, pf, inputs, ops, library in cases}
    err = compare("face_gather er", (kernels.face_gather(Uf, fgeom.er),),
                  (face_gather_plain(Uf, fgeom.er),), dtype_name)
    phase("kernels", f"face_gather er rows={Rf} {dtype_name}: "
          f"max|kernel-plain|={err:.3e}")
    return out


def hump_face_rows(torch, hump, Uh):
    """Random face rows cL, cR (R, F) and a base (R, E) at the R rows of the
    GaussHump state Uh (seed 5), for K6 on the hump path's shapes."""
    gen = torch.Generator(device=Uh.device).manual_seed(5)
    R = Uh.shape[0]
    cL, cR = torch.randn((2, R, hump.nface), generator=gen, device=Uh.device,
                         dtype=Uh.dtype)
    base = torch.randn((R, hump.nelem), generator=gen, device=Uh.device,
                       dtype=Uh.dtype)
    return cL, cR, base


def mm_face_gp_checks(torch, p1_solver, iface_solver, dtype_name, timed):
    """K4 on mm_perturbed's state of the multimat P1 solver (C = 3 nmat + 3
    components), K5 on the interface advection's perturbed P0 state and K6
    on the Dirichlet route's face rows of that state (C + 3 nmat + 1), as
    mm_p1 and mm_iface run them; returns face_gp_kernel_checks' records."""
    sy, g = iface_solver.system, iface_solver.geom
    Uf = mm_perturbed(torch, iface_solver)
    XL, XR = sy.dirichlet_face_rows(g, Uf, 0.0)
    return face_gp_kernel_checks(
        torch, p1_solver.geom, mm_perturbed(torch, p1_solver),
        p1_solver.system.ncomp, g, Uf, XL, XR, None, dtype_name, timed)


def mm_iface_p1_checks(torch, solver, dtype_name, timed):
    """K5 and K6 at the instances of mm_iface_p1's face Gauss-point route,
    bit for bit against their plain versions on the path's limited
    initial state: K5 on the C + 5 nmat rows of K modes (the state and its
    THINC carriers, 108 at nmat 3) at el and er, K5 on the C*K state rows
    of the dt sweep (48) at el and er, and K6 on the route's face rows
    (R*K, 88 at nmat 3) onto the volume term; each timed (el for K5) with
    its one-call yardstick, index_select or index_add_.  Returns {entry:
    record}."""
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.ops.face_accum import (accumulate_faces_plain,
                                                 face_gather_plain)
    from quinoa_tpu_torch.pde.dg import face_gp_rows, volume_rhs

    sy, g = solver.system, solver.geom
    C, K, E, F = sy.ncomp, g.ndof, g.nelem, g.nface
    u = solver._limit(solver.initial_state().u)
    X = sy.thinc_carriers(g, u.reshape(C, K, E))
    Ug = torch.cat([u.reshape(C, K, E), sy.thinc_modes(X, K)]).reshape(
        -1, E).contiguous()
    Rv = volume_rhs(sy, g, u, 0.0)
    cL, cR = face_gp_rows(sy.thinc_facade, g, Ug, 0.0)
    base = torch.cat([Rv, Rv.new_zeros(((sy.nrows - C) * K, E))])
    R = cL.shape[0]
    el, er = g.el.long(), g.er.long()
    inner = el != er
    acc = base.clone()
    src = torch.cat([cL, cR[:, inner]], dim=1)
    idx = torch.cat([el, er[inner]])
    out = {}
    for rows in (Ug, u):
        entry = f"face_gather (R={rows.shape[0]})"
        out[entry] = measure(
            torch, "face_gather", f"E={E} F={F} rows={rows.shape[0]} el",
            lambda rows=rows: kernels.face_gather(rows, g.el),
            lambda rows=rows: face_gather_plain(rows, g.el), (rows, g.el), 0,
            dtype_name, timed,
            lambda rows=rows: torch.index_select(rows, 1, g.el),
            bitwise=True)
        measure(torch, "face_gather", f"E={E} F={F} rows={rows.shape[0]} er",
                lambda rows=rows: kernels.face_gather(rows, g.er),
                lambda rows=rows: face_gather_plain(rows, g.er),
                (rows, g.er), 0, dtype_name, False, bitwise=True)
    out[f"face_accum (R={R})"] = measure(
        torch, "face_accum", f"E={E} F={F} rows={R} onto the volume term",
        lambda: kernels.face_accum(cL, cR, g.fose, g.fsideR, base),
        lambda: accumulate_faces_plain(g, cL, cR, base),
        (cL, cR, g.fose, g.fsideR, base), OPS["face_accum_row"] * R * E,
        dtype_name, timed, lambda: acc.index_add_(1, idx, src), bitwise=True)
    return out


def alecg_solver(name, n, dtype, device, ncomp=1):
    """The ALECG solver of one bench_alecg.py leg on an n = (nx, ny, nz)
    box in Hilbert element and first-touch node order, every boundary
    node pinned; SlotCyl with ncomp components on the transport leg."""
    from quinoa_tpu_torch.inciter.alecg import make_alecg
    from quinoa_tpu_torch.mesh import (box_tet_mesh, first_touch_node_reorder,
                                       hilbert_element_reorder)
    from quinoa_tpu_torch.pde.cg import CGTransport
    from quinoa_tpu_torch.pde.cg_compflow import CGCompFlow
    from quinoa_tpu_torch.pde.problems import SlotCyl, VorticalFlow

    problem, lo, hi, cfl = ALECG[name]
    if n != (N_BIG,) * 3:
        _, lo, hi, cfl = ALECG_SMALL[name]
    system = (CGTransport(SlotCyl(ncomp=ncomp)) if problem == "slotcyl"
              else CGCompFlow(VorticalFlow()))
    mesh, _ = hilbert_element_reorder(box_tet_mesh(*n, lo=lo, hi=hi))
    mesh, _ = first_touch_node_reorder(mesh)
    return make_alecg(system, mesh, cfl=cfl, bcnodes=mesh.all_bnodes(),
                      dtype=dtype, device=device)


def alecg_kernel_checks(torch, solver, dtype_name, timed):
    """K7, K8 (the solver's flavour) and K9 against their plain versions on
    the solver's initial state, then the three as the stage rhs, each bit
    for bit; returns {name: record} (times only when timed)."""
    from quinoa_tpu_torch.ops.alecg_fused import (alecg_edge,
                                                  alecg_edge_plain,
                                                  alecg_rhs, alecg_vol,
                                                  alecg_vol_plain,
                                                  cg_assemble,
                                                  cg_assemble_plain)

    g, e, rows, sy = solver.geom, solver.edget, solver.rows, solver.system
    u = solver.initial_state().u
    cv = alecg_vol_plain(sy, g, rows, u)
    d = alecg_edge_plain(sy, e, rows, u)
    sfx = "" if sy.flavour == "transport" else "_cf"
    R, N, E, nE = u.shape[0], g.nnode, g.nelem, e.edges.shape[1]
    if sfx:
        vol_in, vol_ops = (u, g.inpoelT, g.grad, rows.w), OPS["alecg_vol_cf"]
        edge_in, edge_ops = (u, e.edges, rows.ew), OPS["alecg_edge_cf"]
    else:
        vol_in = (u, g.inpoelT, g.grad, rows.w, rows.vel)
        vol_ops = OPS["alecg_vol_row"] * R
        edge_in, edge_ops = (u, e.edges, rows.ew), OPS["alecg_edge_row"] * R
    # one-call yardstick of K9: index_add_ of cv at its four corners and
    # of +d/-d at the edge endpoints
    acc = torch.zeros((R, N), dtype=u.dtype, device=u.device)
    src = torch.cat([cv.repeat(1, 4), d, -d], dim=1)
    idx = torch.cat([g.inpoelT.reshape(-1), e.edges.reshape(-1)]).long()
    slots = int(g.nsup.shape[0] + e.ensup.shape[0]) * N
    cases = (
        ("alecg_vol" + sfx, lambda: alecg_vol(sy, g, rows, u),
         lambda: alecg_vol_plain(sy, g, rows, u), vol_in, vol_ops * E, None),
        ("alecg_edge" + sfx, lambda: alecg_edge(sy, e, rows, u),
         lambda: alecg_edge_plain(sy, e, rows, u), edge_in, edge_ops * nE,
         None),
        ("cg_assemble", lambda: cg_assemble(cv, d, g.nsup, e.ensup),
         lambda: cg_assemble_plain(cv, d, g.nsup, e.ensup),
         (cv, d, g.nsup, e.ensup), OPS["cg_assemble_slot"] * R * slots,
         lambda: acc.index_add_(1, idx, src)),
    )
    out = {name: measure(torch, name, f"N={N} E={E} nE={nE} rows={R}", kf,
                         pf, inputs, ops, dtype_name, timed, library,
                         bitwise=True)
           for name, kf, pf, inputs, ops, library in cases}
    if not bit_identical((alecg_rhs(sy, g, e, rows, u),),
                         (cg_assemble_plain(cv, d, g.nsup, e.ensup),)):
        raise AssertionError(f"stage rhs K7+K8+K9{sfx} ({dtype_name}): not "
                             "bit-identical to the plain versions")
    phase("kernels", f"K7+K8+K9{sfx} {dtype_name} N={N} E={E} nE={nE} "
          f"rows={R}: the stage rhs is bit-identical to the plain versions")
    return out


def diagcg_solver(name, dtype, device, small=False):
    """The DiagCG + FCT solver of one DIAGCG leg (DIAGCG_SMALL when small)
    on a box in Hilbert element and first-touch node order, every boundary
    node pinned."""
    from quinoa_tpu_torch.inciter import DiagCGSolver
    from quinoa_tpu_torch.mesh import (box_tet_mesh, first_touch_node_reorder,
                                       hilbert_element_reorder)
    from quinoa_tpu_torch.pde.cg import CGTransport, make_cggeom
    from quinoa_tpu_torch.pde.cg_compflow import CGCompFlow
    from quinoa_tpu_torch.pde.problems import SlotCyl, VorticalFlow

    problem, n, lo, hi, cfl = DIAGCG[name]
    n = (n,) * 3
    if small:
        n, lo, hi = DIAGCG_SMALL[name]
    system = (CGTransport(SlotCyl()) if problem == "slotcyl"
              else CGCompFlow(VorticalFlow()))
    mesh, _ = hilbert_element_reorder(box_tet_mesh(*n, lo=lo, hi=hi))
    mesh, _ = first_touch_node_reorder(mesh)
    return DiagCGSolver(system, make_cggeom(mesh, dtype=dtype, device=device),
                        cfl=cfl, bcnodes=mesh.all_bnodes())


def diagcg_kernel_checks(torch, solver, dtype_name, timed):
    """K10 on the solver's initial state (and on 2C rows, as the limiter's
    gather) and K11 at the three calls of a step, bit for bit: the rhs +
    diffusion sums (2C rows), the P sums + Q maxima (2C + 2C rows, Q one
    row per element) and the limited A sums (C rows), each timed with its
    one-call yardstick (index_add_ for the sums; none for P + Q); then
    max rows alone (fct.alw's call, off the step: bits only) and a NaN in
    a max row.  Returns {name: record}: K10 at C rows as "node_gather",
    K11 as "node_assemble (R=2C)", "node_assemble P+Q (R=2C+2C)" and
    "node_assemble A (R=C)" (times only when timed)."""
    from quinoa_tpu_torch.ops.node_window import (node_assemble,
                                                  node_assemble_plain,
                                                  node_gather,
                                                  node_gather_plain)

    g = solver.geom
    u = solver.initial_state().u
    C, N, E, D = u.shape[0], g.nnode, g.nelem, g.nsup.shape[0]
    gen = torch.Generator(device=u.device).manual_seed(17)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=u.device,
                           dtype=u.dtype)

    u2 = randn(2 * C, N)
    xa2, xa1 = randn(4, 2 * C, E), randn(4, C, E)
    xm = randn(1, 2 * C, E)
    idx = g.inpoelT.reshape(-1).long()

    def add_call(x):
        acc = torch.zeros((x.shape[1], N), dtype=x.dtype, device=x.device)
        src = x.permute(1, 0, 2).reshape(x.shape[1], 4 * E)
        return lambda: acc.index_add_(1, idx, src)

    out = {}
    for rows, U in ((C, u), (2 * C, u2)):
        rec = measure(torch, "node_gather", f"N={N} E={E} rows={rows}",
                      lambda U=U: node_gather(U, g.inpoelT),
                      lambda U=U: node_gather_plain(U, g.inpoelT),
                      (U, g.inpoelT), 0, dtype_name, timed,
                      lambda U=U: torch.index_select(U, 1, idx),
                      bitwise=True)
        out.setdefault("node_gather", rec)
    slots = OPS["node_assemble_slot"] * D * N
    for key, label, xa, m, lib, when in (
            (f"node_assemble (R={2 * C})", "rhs+diffusion sums", xa2, None,
             add_call(xa2), timed),
            (f"node_assemble P+Q (R={2 * C}+{2 * C})", "P sums + Q maxima",
             xa2, xm, None, timed),
            (f"node_assemble A (R={C})", "limited A sums", xa1, None,
             add_call(xa1), timed),
            (None, "Q maxima alone (off the step)", None, xm, None, False)):
        rows = (0 if xa is None else xa.shape[1]) + (
            0 if m is None else m.shape[1])
        rec = measure(torch, "node_assemble",
                      f"{label} N={N} E={E} D={D} rows={rows}",
                      lambda xa=xa, m=m: node_assemble(xa, m, g.nsup),
                      lambda xa=xa, m=m: node_assemble_plain(xa, m, g.nsup),
                      [t for t in (xa, m, g.nsup) if t is not None],
                      slots * rows, dtype_name, when, lib, bitwise=True)
        if key is not None:
            out[key] = rec
    bad = xm.clone()
    bad[0, 2 * C - 1, E // 3] = float("nan")
    got = node_assemble(xa2, bad, g.nsup)
    want = node_assemble_plain(xa2, bad, g.nsup)
    nan = torch.isnan(got)
    if not (bool(torch.equal(nan, torch.isnan(want)))
            and int(nan[2 * C:].sum()) == 4 and int(nan[:2 * C].sum()) == 0):
        raise AssertionError(f"node_assemble {dtype_name}: a NaN slot gives "
                             f"{int(nan.sum())} NaN maxima, the plain version "
                             f"{int(torch.isnan(want).sum())}")
    phase("kernels", f"node_assemble {dtype_name}: a NaN element row "
          "propagates to the maxima of its 4 nodes, as in the plain version")
    return out


def card_vs_cpu(torch, name, make, t0=0.0):
    """Two float64 steps of make(device) from its initial state at t0 on
    the card and on the CPU; ndofel must agree where the state has one
    (DG).  On paths 12-18 (MM) and the SCHEMES solvers the atol is
    SOLVER_ATOL of max(1, max|u|) (the multimat energies reach 2.5e5),
    elsewhere SOLVER_ATOL."""
    on_card, on_cpu = make("card"), make("cpu")
    sa = on_card.nsteps(on_card.initial_state(t0), 2)
    sb = on_cpu.nsteps(on_cpu.initial_state(t0), 2)
    err = float((sa.u.cpu() - sb.u).abs().max())
    dterr = abs(float(sa.dt) - float(sb.dt))
    dg = hasattr(sb, "ndofel")
    same = not dg or bool(torch.equal(sa.ndofel.cpu(), sb.ndofel))
    scaled = name in MM or name in SCHEMES
    atol = SOLVER_ATOL * (max(1.0, float(sb.u.abs().max())) if scaled
                          else 1.0)
    if not (err <= atol and dterr <= 1e-12 * float(sb.dt) and same):
        raise AssertionError(f"{name} card vs CPU: |du|={err:.3e} "
                             f"|ddt|={dterr:.3e} ndofel equal: {same}")
    extra = (f", ndofel equal, P1 elements {int((sb.ndofel == 4).sum())}"
             if dg else f", N={on_cpu.geom.nnode}")
    phase("kernels", f"small solver {name} (E={on_cpu.geom.nelem}, f64, 2 "
          f"steps) card vs CPU: max|du|={err:.3e} |ddt|={dterr:.3e}"
          f"{extra} (atol {atol:g}, dt rtol 1e-12)")


#: the small float64 card-vs-CPU solvers of the schemes, sources and
#: problems ported last: (solver, problem, ndof or None for CG, faces,
#: mesh cells, box lo, box hi, cfl, t0, solver keywords)
SCHEMES = {
    "sedov_wenop1": ("dg", "SedovBlastwave", 4, "symmetry", SMALL,
                     (0.0, 0.0, 0.0), (0.6, 0.6, 0.4), 0.5, 0.0,
                     {"limiter": "wenop1"}),
    "sedov_p0p1": ("dg", "SedovBlastwave", 4, "symmetry", SMALL,
                   (0.0, 0.0, 0.0), (0.6, 0.6, 0.4), 0.5, 0.0,
                   {"limiter": "superbeep1", "evolve_ndof": 1}),
    "nlenergygrowth_p1": ("dg", "NLEnergyGrowth", 4, "symmetry", SMALL,
                          (0.0, 0.0, 0.0), (0.6, 0.6, 0.4), 0.5, 0.0,
                          {"limiter": "superbeep1"}),
    "rayleightaylor_p1": ("dg", "RayleighTaylor", 4, "dirichlet", (4, 4, 3),
                          (0.0, 0.0, 0.0), (0.4, 0.4, 0.3), 0.5, 0.0,
                          {"limiter": "superbeep1"}),
    "gausshump_p2": ("dg", "GaussHump", 10, "dirichlet", (4, 4, 2),
                     (0.0, 0.0, 0.0), (1.0, 1.0, 0.5), 0.5, 0.0, {}),
    "taylorgreen_p2_superbee": ("dg", "TaylorGreen", 10, "symmetry",
                                P2_SMALL, (0.0, 0.0, 0.0), (1.0, 1.0, 0.75),
                                0.5, 0.0, {"limiter": "superbeep1"}),
    "diagcg_cyladvect": ("diagcg", "CylAdvect", None, None, (12, 12, 3),
                         (0.0, 0.0, 0.0), (1.0, 1.0, 0.25), 0.8, 0.0, {}),
    "diagcg_sheardiff": ("diagcg", "ShearDiff", None, None, (8, 4, 4),
                         (0.0, -0.25, -0.25), (1.0, 0.25, 0.25), 0.5, 1.0,
                         {}),
    "diagcg_rayleightaylor": ("diagcg", "RayleighTaylor", None, None,
                              (5, 5, 5), (-0.5, -0.5, -0.5),
                              (0.5, 0.5, 0.5), 0.5, 0.0, {}),
    "alecg_rayleightaylor": ("alecg", "RayleighTaylor", None, None,
                             (5, 5, 5), (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5),
                             0.5, 0.0, {}),
}


def scheme_solver(torch, name, device):
    """The SCHEMES solver `name` in float64 on device ("card" or "cpu"):
    DG on a Hilbert-ordered box, CG with every boundary node pinned."""
    import quinoa_tpu_torch.pde.problems as problems
    from quinoa_tpu_torch.inciter import DiagCGSolver, make_alecg
    from quinoa_tpu_torch.inciter.dg import DGSolver
    from quinoa_tpu_torch.mesh import box_tet_mesh, hilbert_element_reorder
    from quinoa_tpu_torch.pde.cg import CGTransport, make_cggeom
    from quinoa_tpu_torch.pde.cg_compflow import CGCompFlow
    from quinoa_tpu_torch.pde.dg import (BC_DIRICHLET, BC_SYMMETRY,
                                         build_dggeom)
    from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow, DGTransport

    kind, problem, ndof, faces, n, lo, hi, cfl, _, kw = SCHEMES[name]
    where = "cuda" if device == "card" else "cpu"
    prob = getattr(problems, problem)()
    transport = hasattr(prob, "velocity")
    mesh = box_tet_mesh(*n, lo=lo, hi=hi)
    if kind == "dg":
        mesh, _ = hilbert_element_reorder(mesh)
        code = BC_DIRICHLET if faces == "dirichlet" else BC_SYMMETRY
        g = build_dggeom(mesh, ndof, {i: code for i in range(1, 7)},
                         dtype=torch.float64, device=where)
        system = DGTransport(prob) if transport else DGCompFlow(prob)
        return DGSolver(system, g, cfl=cfl, **kw)
    system = CGTransport(prob) if transport else CGCompFlow(prob)
    if kind == "alecg":
        return make_alecg(system, mesh, cfl=cfl, bcnodes=mesh.all_bnodes(),
                          dtype=torch.float64, device=where)
    return DiagCGSolver(system, make_cggeom(mesh, dtype=torch.float64,
                                            device=where),
                        cfl=cfl, bcnodes=mesh.all_bnodes())


def drive(torch, solver, name, card, state=None):
    """1 warm-up and NSTEPS timed steps of one path, with the launch
    counts zeroed just before and read just after; returns (state,
    counts, wall seconds of the timed steps)."""
    from quinoa_tpu_torch import kernels

    if state is None:
        state = solver.initial_state()
    torch.cuda.synchronize()
    kernels.reset_launches()
    state = solver.step(state)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NSTEPS):
        state = solver.step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    want = {k: (NSTEPS + 1) * PATHS[name].get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{name}: kernel launches {counts}, expected "
                             f"{want}")
    if not bool(torch.isfinite(state.u).all()):
        raise AssertionError(f"{name}: non-finite state after "
                             f"{NSTEPS + 1} steps")
    if name in ALECG or name in DIAGCG:
        # bench_alecg.py:66, bench_cg.py:57
        unit, n = "node-updates/s", solver.geom.nnode
    else:
        unit, n = "cell-updates/s", solver.geom.nelem
    phase(name, f"{n * NSTEPS / wall:.1f} {unit}, "
          f"{1e3 * wall / NSTEPS:.3f} ms/step, t={float(state.t):.9e}, "
          f"launches {counts}, on {card}")
    return state, counts, wall


def kinds(name, ncomp):
    """The component rows of each kind (Euler: density, momentum, energy;
    multimat: fractions, partial densities, momentum, energies)."""
    if name in EULER:
        return [[0], [1, 2, 3], [4]]
    nmat = (ncomp - 3) // 3
    return [list(range(nmat)), list(range(nmat, 2 * nmat)),
            list(range(2 * nmat, 2 * nmat + 3)),
            list(range(2 * nmat + 3, ncomp))]


def l2_gate(name, solver, state):
    """L2(sol), and L2(err) where JAX_L2 holds it, after 11 float32 steps
    against JAX_L2 at rtol JAX_L2_RTOL plus L2_ULPS (L2_ULPS_BY_PATH)
    float32 ulps of the path's L2_SCALE."""
    from quinoa_tpu_torch.inciter.dg import DGDiagnostics
    from quinoa_tpu_torch.inciter.diagnostics import Diagnostics

    if hasattr(state, "ndofel"):
        l2sol, l2err, _ = DGDiagnostics(solver.system,
                                        solver.geom).compute(state)
    else:
        row = Diagnostics(solver.system, solver.geom).compute(state)
        l2sol, l2err = row.l2sol, row.l2err
    want = JAX_L2[name]
    sol = want["l2sol"]
    rule = L2_SCALE.get(name, "own")
    if rule == "largest":
        scale = [max(sol)] * len(sol)
    elif rule == "kind":
        scale = [0.0] * len(sol)
        for rows in kinds(name, len(sol)):
            for j in rows:
                scale[j] = max(sol[i] for i in rows)
    else:
        scale = sol
    eps = float(np.finfo(np.float32).eps)
    ulps = L2_ULPS_BY_PATH.get(name, L2_ULPS)

    def close(got, ref, ulps):
        return all(abs(a - b) <= JAX_L2_RTOL * abs(b) + ulps * eps * s
                   for a, b, s in zip(got, ref, scale))

    ok = close(l2sol, sol, 0 if rule == "own" else ulps)
    msg = (f"after {int(state.it)} steps t={float(state.t):.9e}: L2(sol) "
           f"{l2sol} vs JAX {sol}, max rel "
           f"{max(abs(a - b) / abs(b) for a, b in zip(l2sol, sol)):.3e}")
    if "l2err" in want:
        ok = ok and close(l2err, want["l2err"], ulps)
        msg += f"; L2(err) {l2err} vs JAX {want['l2err']}"
    else:
        msg += f"; L2(err) {l2err} (not gated)"
    of = {"own": "the component's own L2(sol), on L2(err) only",
          "largest": "the largest L2(sol)",
          "kind": "the largest L2(sol) of the component's kind"}[rule]
    phase(name, f"{msg}: {'ok' if ok else 'FAIL'} (rtol {JAX_L2_RTOL:g} + "
          f"{ulps} f32 ulps of {of})")
    if not ok:
        raise AssertionError(f"{name}: L2 gate failed")


def alpha_gate(name, solver, state):
    """The multimat cell-mean fractions after 11 float32 steps: minimum
    above -ALPHA_MIN_ULPS float32 ulps of 1, |sum - 1| below
    ALPHA_SUM_TOL."""
    sy = solver.system
    al = state.u.reshape(sy.ncomp, solver.geom.ndof, -1)[:sy.nmat, 0]
    amin = float(al.min())
    serr = float((al.sum(dim=0) - 1.0).abs().max())
    ok = (amin > -ALPHA_MIN_ULPS * float(np.finfo(np.float32).eps)
          and serr < ALPHA_SUM_TOL)
    phase(name, f"min alpha {amin:.4e} (> -{ALPHA_MIN_ULPS} f32 ulps), "
          f"max|sum alpha - 1| {serr:.4e} (< {ALPHA_SUM_TOL:g}): "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: fraction gate failed")


def bounds_gate(solver, state, u0, name="diagcg"):
    """min and max of u within BOUNDS_ULPS float32 ulps of the initial
    state's bounds (FCT monotonicity up to round-off)."""
    lo, hi = float(u0.min()), float(u0.max())
    slack = BOUNDS_ULPS * float(np.spacing(np.float32(max(abs(lo), abs(hi)))))
    umin, umax = float(state.u.min()), float(state.u.max())
    ok = lo - slack <= umin and umax <= hi + slack
    phase(name, f"after {int(state.it)} steps min {umin:.9e} max "
          f"{umax:.9e}, initial [{lo:.9e}, {hi:.9e}] +- {slack:.3e} "
          f"({BOUNDS_ULPS} f32 ulps): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: FCT bounds gate failed")


def profile_path(torch, solver, name, state, step_s, steps=5):
    """steps steps under torch.profiler: wall ms/step (host clock around
    work ending in a synchronize, profiler on), device busy ms/step (the
    union of the device activity intervals), the idle share against that
    wall and against step_s (the unprofiled seconds a step of drive()),
    kernel launches a step (the runtime's launch calls) and the largest
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = solver.step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name, launches = [], {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        elif "LaunchKernel" in e.name:
            launches += 1
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if not spans:
        phase(name, "profiler: no device activity recorded; device busy "
              "and idle not measured")
        return state
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy_s = busy / 1e6 / steps
    phase(name, f"profiler over {steps} steps: wall {1e3 * wall / steps:.4f}"
          f" ms/step, device busy {1e3 * busy_s:.4f} ms/step, idle "
          f"{100.0 * (1.0 - busy_s * steps / wall):.1f}% of the profiled "
          f"step and {100.0 * (1.0 - busy_s / step_s):.1f}% of the "
          f"unprofiled one ({1e3 * step_s:.4f} ms), {launches / steps:.1f}"
          " launches/step; largest (ms/step): "
          + ", ".join(f"{k[:40]} {v / 1e3 / steps:.4f}" for k, v in top))
    return state


def host_ms(torch, fn, reps=5):
    """Median host-clock ms of fn() ending in a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def p2_breakdown(torch, solver, state, reps=5):
    """Host-clock ms of one P2 stage's parts, each call ending in a
    synchronize (median of reps): the volume integral with its source,
    the source alone, and the face pass K12 + K13."""
    from quinoa_tpu_torch.ops.face_fused import fused_face_pass
    from quinoa_tpu_torch.pde.dg import volume_rhs

    g, sy, u, t = solver.geom, solver.system, state.u, state.t
    vol = host_ms(torch, lambda: volume_rhs(sy, g, u, t), reps)
    src = host_ms(torch, lambda: sy.src(g.vol_gp, t), reps)
    face = host_ms(torch, lambda: fused_face_pass(sy, g, u), reps)
    phase("p2", f"one stage's parts (host clock to a synchronize, median of "
          f"{reps}): volume integral with source {vol:.3f} ms, of it the "
          f"source {src:.3f} ms; face pass K12 + K13 {face:.3f} ms")


def mm_breakdown(torch, solver, name, state, reps=5):
    """Host-clock ms of one multimat P1 stage's parts, each call ending in
    a synchronize (median of reps): the consistent Superbee limit (K4 and
    the torch phi), the volume integral, with THINC the carriers, the face
    pass (K14 + K13, or on Dirichlet faces the face Gauss-point route: K5,
    the ghost, THINC and AUSM+up in torch, K6; then also the stage-0 dt
    sweep, K5 and torch), the non-conservative volume terms and the alpha
    closure."""
    from quinoa_tpu_torch.ops.face_fused import mm_face_pass
    from quinoa_tpu_torch.pde.dg import volume_rhs
    from quinoa_tpu_torch.pde.multimat import clean_alpha_closure

    sy, g, u, t = solver.system, solver.geom, state.u, state.t
    C, K = sy.ncomp, g.ndof
    Uv = u.reshape(C, K, -1)
    X = sy.thinc_carriers(g, Uv) if sy.intsharp else None
    if sy.fused_ok:
        face = {"face pass K14 + K13": lambda: mm_face_pass(sy, g, u, X)}
        acc = mm_face_pass(sy, g, u, X)[0]
    else:
        Rv = volume_rhs(sy, g, u, t)
        face = {"face Gauss-point pass K5 + torch + K6":
                lambda: sy.dirichlet_face_gp_sums(g, u, X, Rv, t),
                "dt sweep K5 + torch": lambda: sy.dt(g, u)}
        acc = sy.dirichlet_face_gp_sums(g, u, X, Rv, t)
    _, dap, divu = sy._split_acc(acc, K)
    parts = {
        "limit": lambda: solver._limit(u),
        "volume integral": lambda: volume_rhs(sy, g, u, t),
        **({"THINC carriers": lambda: sy.thinc_carriers(g, Uv)}
           if sy.intsharp else {}),
        **face,
        "non-conservative terms": lambda: sy._nonconservative_ho(
            g, Uv, dap, divu),
        "alpha closure": lambda: clean_alpha_closure(u, C, K, sy.nmat),
    }
    phase(name, f"one stage's parts (host clock to a synchronize, median "
          f"of {reps}): " + ", ".join(
              f"{name} {host_ms(torch, fn, reps):.3f} ms"
              for name, fn in parts.items()))


def cli_run(argv, device, path="cli"):
    """quinoa_tpu_torch.cli.main(argv) in process on device; returns its
    standard output, which is also printed line by line under path."""
    import contextlib
    import io

    from quinoa_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv, device=device)
    out = buf.getvalue()
    for line in out.splitlines():
        phase(path, "  | " + line)
    if rc != 0:
        raise AssertionError(f"{path}: {argv} exited {rc}")
    return out


def diag_lines(path):
    """The data rows of a diagnostics file, as text."""
    with open(path) as fh:
        return [line.rstrip("\n") for line in fh if not line.startswith("#")]


def profile_table(out):
    """{phase: (seconds, entries)} from a --profile table in out."""
    rows = {}
    for line in out.splitlines():
        parts = line.rsplit(None, 3)
        if len(parts) == 4 and parts[3].isdigit():
            rows[parts[0].strip()] = (float(parts[1]), int(parts[3]))
    return rows


def small_cli_deck(name):
    scheme, extra, block, _, _, cfl = CLI_SMALL[name]
    return (f"inciter\n  nstep {CLI_SMALL_NSTEP}\n  cfl {cfl}\n"
            f"  scheme {scheme} {extra}\n  {block}\n"
            "  diagnostics interval 1 end\nend\n")


def cli_small_decks(torch, d, card_dev):
    """Each CLI_SMALL deck through the command on the card and on the CPU
    in float64: the diag rows agree under card_vs_cpu's tolerances (it
    equal; t and dt rtol 1e-12; norms atol SOLVER_ATOL of max(1, the
    row's largest L2(sol)))."""
    from quinoa_tpu_torch.io import write_exodus
    from quinoa_tpu_torch.mesh import box_tet_mesh

    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for name, (_, _, _, lo, hi, _) in CLI_SMALL.items():
            deck, mesh = (os.path.join(d, f"{name}.q"),
                          os.path.join(d, f"{name}.exo"))
            with open(deck, "w") as fh:
                fh.write(small_cli_deck(name))
            write_exodus(mesh, box_tet_mesh(*CLI_SMALL_BOX, lo=lo, hi=hi))
            rows = {}
            for where, device in (("card", card_dev), ("cpu", "cpu")):
                diag = os.path.join(d, f"{name}.{where}.diag")
                cli_run(["inciter", "-c", deck, "-i", mesh, "--diag", diag,
                         "-o", os.path.join(d, f"{name}.{where}"), "-b"],
                        device)
                rows[where] = np.array([[float(x) for x in line.split()]
                                        for line in diag_lines(diag)])
            rows_card_vs_cpu("cli", name, rows["card"], rows["cpu"],
                             CLI_SMALL_NSTEP)
    finally:
        torch.set_default_dtype(prev)


def rows_card_vs_cpu(path, name, a, b, nrows):
    """Diag rows of a float64 run on the card (a) and on the CPU (b) agree
    under card_vs_cpu's tolerances: nrows each, it equal, t and dt rtol
    1e-12, norms atol SOLVER_ATOL of max(1, the row's largest L2(sol))."""
    ncomp = (b.shape[1] - 3) // 3
    atol = SOLVER_ATOL * np.maximum(
        1.0, np.abs(b[:, 3:3 + ncomp]).max(axis=1, keepdims=True))
    ok = (a.shape == b.shape == (nrows, b.shape[1])
          and np.array_equal(a[:, 0], b[:, 0])
          and np.allclose(a[:, 1:3], b[:, 1:3], rtol=1e-12, atol=0)
          and bool((np.abs(a[:, 3:] - b[:, 3:]) <= atol).all()))
    err = float(np.abs(a[:, 3:] - b[:, 3:]).max()) if ok else None
    phase(path, f"small deck {name} (f64, {nrows} steps) card vs CPU: "
          f"{'ok' if ok else 'FAIL'}, max |d norm| {err}")
    if not ok:
        raise AssertionError(f"{path}: {name} card vs CPU rows differ:"
                             f"\n{a}\n{b}")


def cli_phase(torch, dev, card, big):
    """Path 19: the Sedov DG(P1) main path through the port's inciter
    command at 48^3, float32, on the card: run A (checkpoint at
    CLI_RSFREQ, field output at the end, --profile), run B (--restart
    from A's checkpoint), run C (-b, one diag row, --profile: the timing
    run), an in-process DGSolver on box_geom's 48^3 geometry (big) for
    reference, run D (A's deck with -v and --trace-dir: trace_run); then
    the CLI_SMALL decks card against CPU and one run of
    `python3 -m quinoa_tpu_torch inciter`."""
    import tempfile

    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.control import load_inciter
    from quinoa_tpu_torch.inciter.dg import DGDiagnostics, DGSolver
    from quinoa_tpu_torch.io import read_exodus_elem_fields, write_exodus
    from quinoa_tpu_torch.mesh import box_tet_mesh
    from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow
    from quinoa_tpu_torch.pde.problems import SedovBlastwave

    phase("cli", card)
    if torch.get_default_dtype() != torch.float32:
        raise AssertionError("cli: the main run is float32, torch's default")
    with tempfile.TemporaryDirectory(prefix="quinoa_cli_") as d:
        t0 = time.perf_counter()
        mesh = os.path.join(d, "box48.exo")
        write_exodus(mesh, box_tet_mesh(N_BIG, N_BIG, N_BIG))
        phase("cli", f"48^3 box written ({os.path.getsize(mesh)} bytes, "
              f"{time.perf_counter() - t0:.1f} s)")
        decks = {}
        for tag, interval in (("A", 1), ("C", CLI_NSTEP)):
            decks[tag] = os.path.join(d, f"sedov_{tag}.q")
            text = CLI_DECK.format(nstep=CLI_NSTEP, interval=interval)
            with open(decks[tag], "w") as fh:
                fh.write(text)
            cfg = load_inciter(text)
            want = dict(scheme="dgp1", flux="hllc", limiter="superbeep1",
                        cfl=0.5, pde="compflow", problem="sedov_blastwave",
                        gamma=1.4, bc_sym=[1, 2, 3, 4, 5, 6],
                        nstep=CLI_NSTEP, diag_interval=interval, pref=False)
            got = {k: getattr(cfg, k) for k in want}
            if got != want:
                raise AssertionError(f"cli: deck {tag} loads {got}")
        ck = os.path.join(d, "ck")
        base = {t: ["inciter", "-c", decks["C" if t == "C" else "A"], "-i",
                    mesh, "--diag", os.path.join(d, f"{t}.diag"), "-o",
                    os.path.join(d, t)] for t in "ABCD"}

        # run A: launches counted from 0 just before, read just after
        torch.cuda.synchronize()
        kernels.reset_launches()
        out_a = cli_run(base["A"] + ["-r", str(CLI_RSFREQ),
                                     "--checkpoint-dir", ck, "--profile"],
                        dev)
        counts = dict(kernels.launches)
        want = {k: (3 * CLI_NSTEP if k in CLI_KERNELS else 0)
                for k in counts}
        phase("cli", f"run A launches {counts}")
        if counts != want:
            raise AssertionError(f"cli: run A launched {counts}, expected "
                                 f"{want}")
        rows_a = diag_lines(os.path.join(d, "A.diag"))
        if [int(r.split()[0]) for r in rows_a] != list(
                range(1, CLI_NSTEP + 1)):
            raise AssertionError(f"cli: run A rows {rows_a}")

        # run B: restart from A's checkpoint at CLI_RSFREQ
        cli_run(base["B"] + ["-b", "--restart", ck], dev)
        rows_b = diag_lines(os.path.join(d, "B.diag"))
        ok = rows_b == rows_a[CLI_RSFREQ:]
        phase("cli", f"run B restarted at it={CLI_RSFREQ}: rows "
              f"{[int(r.split()[0]) for r in rows_b]} "
              f"{'equal' if ok else 'DIFFER from'} run A's as printed")
        if not ok:
            raise AssertionError(f"cli: restart rows {rows_b} vs "
                                 f"{rows_a[CLI_RSFREQ:]}")

        # run C: the timing run
        out_c = cli_run(base["C"] + ["-b", "--profile"], dev)
        rows_c = diag_lines(os.path.join(d, "C.diag"))
        if len(rows_c) != 1 or rows_c[0] != rows_a[-1]:
            raise AssertionError(f"cli: run C rows {rows_c}")

        # the in-process reference on box_geom's geometry
        system = DGCompFlow(SedovBlastwave(), riemann_flux="hllc")
        solver = DGSolver(system, big, cfl=0.5, limiter="superbeep1")
        state = solver.initial_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CLI_NSTEP):
            state = solver.step(state)
        torch.cuda.synchronize()
        drive_ms = 1e3 * (time.perf_counter() - t0) / CLI_NSTEP
        l2sol = DGDiagnostics(system, big).compute(state)[0]
        printed = [f"{v:.12e}" for v in l2sol]
        cli_l2 = rows_a[-1].split("\t")[3:3 + len(l2sol)]
        ok = cli_l2 == printed
        phase("cli", f"row {CLI_NSTEP} L2(sol) {cli_l2} vs the in-process "
              f"DGSolver's {printed}: {'equal' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError("cli: L2(sol) differs from the in-process "
                                 "run")

        # A's field output reads back with the JAX package's names
        names, times, vals = read_exodus_elem_fields(
            os.path.join(d, f"A.e-s.{CLI_NSTEP}.exo"))
        want = [f"{v}_{kind}" for kind in ("numerical", "analytical")
                for v in ("density", "x-velocity", "y-velocity",
                          "z-velocity", "specific_total_energy",
                          "pressure")]
        finite = bool(np.isfinite(vals).all())
        phase("cli", f"field output A.e-s.{CLI_NSTEP}.exo: {len(names)} "
              f"element fields of {vals.shape[-1]} cells at t="
              f"{float(times[-1])!r}, finite {finite}")
        if names != want or vals.shape[-1] != big.nelem or not finite:
            raise AssertionError(f"cli: field output {names} "
                                 f"{vals.shape}")

        prof_a, prof_c = profile_table(out_a), profile_table(out_c)
        for tag, prof in (("A", prof_a), ("C", prof_c)):
            phase("cli", f"run {tag} phases (s, entries): " + ", ".join(
                f"{k} {v[0]:.3f} {v[1]}" for k, v in prof.items()))
        sec, n = prof_c["timestep"]
        phase("cli", f"run C timestep {1e3 * sec / n:.4f} ms/step over {n} "
              f"steps (a host read of it each step) vs the in-process "
              f"DGSolver {drive_ms:.4f} ms/step over {CLI_NSTEP} steps "
              f"(one synchronize at the end), on {card}")

        trace_run(torch, dev, card, base["D"], rows_a, prof_c)

        cli_small_decks(torch, d, dev)

        # one small deck as a command of its own, on the card
        deck = os.path.join(d, f"{CLI_SUBPROCESS}.q")
        mesh = os.path.join(d, f"{CLI_SUBPROCESS}.exo")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "quinoa_tpu_torch", "inciter", "-c",
             deck, "-i", mesh, "--diag", os.path.join(d, "sub.diag"), "-o",
             os.path.join(d, "sub")], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=600)
        rows = diag_lines(os.path.join(d, "sub.diag")) if os.path.exists(
            os.path.join(d, "sub.diag")) else []
        phase("cli", f"python3 -m quinoa_tpu_torch inciter ({CLI_SUBPROCESS}"
              f", float32): exit {res.returncode}, {len(rows)} rows, "
              f"{time.perf_counter() - t0:.1f} s")
        if res.returncode != 0 or len(rows) != CLI_SMALL_NSTEP:
            raise AssertionError(f"cli: the command failed:\n{res.stdout}"
                                 f"\n{res.stderr[-4000:]}")
    return counts


#: path 19's run D: the inciter command in a process of its own that
#: counts the kernels' launches from 0 and prints them last
TRACE_RUN = ("import json, sys\n"
             "from quinoa_tpu_torch import kernels\n"
             "from quinoa_tpu_torch.cli import main\n"
             "kernels.build()\n"
             "kernels.reset_launches()\n"
             "rc = main(sys.argv[1:])\n"
             "print(json.dumps(kernels.launches))\n"
             "raise SystemExit(rc)\n")


def trace_run(torch, dev, card, argv, rows_a, prof_c):
    """Path 19's run D: run A's deck (argv) with -b -v --profile and
    --trace-dir, as `quinoa_tpu_torch.cli.main` on the card in a process
    of its own (TRACE_RUN), in a directory of its own.  A torch.profiler
    session in a process that has run profiler windows before has lost
    3 to 17 of its 3047 kernel records on the H100 (my chip runs), and
    this run's gate counts every launch; a new process has lost none.
    Gates: the three mesh statistics lines and the three mesh PDFs in
    that directory, the trace's device events of each CLI_KERNELS kernel
    as many as kernels.launches counts (33), run A's rows digit for
    digit.  Prints the timestep ms/step beside run C's (the trace's
    overhead)."""
    from quinoa_tpu_torch.base.profiler import TRACE_FILE

    dd = os.path.dirname(argv[argv.index("-o") + 1])
    dd = os.path.join(dd, "D_run")
    os.makedirs(dd)
    trace = os.path.join(dd, "trace")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", TRACE_RUN, *argv, "-b",
                          "-v", "--profile", "--trace-dir", trace], cwd=dd,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    out = res.stdout
    for line in out.splitlines():
        phase("cli", "  | " + line)
    if res.returncode != 0:
        raise AssertionError(f"cli: run D exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")
    counts = json.loads(out.splitlines()[-1])
    phase("cli", f"run D: a process of its own, {time.perf_counter() - t0:.1f}"
          f" s, launches {counts}")
    want = {k: (3 * CLI_NSTEP if k in CLI_KERNELS else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"cli: run D launched {counts}")
    stats = [ln for ln in out.splitlines()
             if ln.startswith("Mesh statistics")]
    pdfs = {f: os.path.getsize(os.path.join(dd, f))
            if os.path.exists(os.path.join(dd, f)) else 0
            for f in ("mesh_edge_pdf.txt", "mesh_vol_pdf.txt",
                      "mesh_ntet_pdf.txt")}
    ntet = N_BIG ** 3 * 6
    ok = (len(stats) == 3 and stats[2].endswith(f"{ntet} / {ntet} / {ntet}")
          and all(pdfs.values()))
    phase("cli", f"run D -v: {stats}, PDFs (bytes) {pdfs}: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli: run D's mesh statistics or PDFs")
    with open(os.path.join(trace, TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    kern = [e["name"] for e in events if e.get("cat") == "kernel"]
    seen = {k: sum(k in name for name in kern) for k in CLI_KERNELS}
    ok = seen == {k: counts[k] for k in CLI_KERNELS}
    phase("cli", f"run D trace: {len(events)} events, {len(kern)} device "
          f"kernels, of them {seen} vs launches "
          f"{ {k: counts[k] for k in CLI_KERNELS} }: {'ok' if ok else 'FAIL'}"
          f" ({os.path.getsize(os.path.join(trace, TRACE_FILE))} bytes)")
    if not ok:
        raise AssertionError("cli: the trace's kernel events differ from "
                             "the launch counts")
    rows_d = diag_lines(argv[argv.index("--diag") + 1])
    ok = rows_d == rows_a
    phase("cli", f"run D rows {'equal' if ok else 'DIFFER from'} run A's "
          "digit for digit")
    if not ok:
        raise AssertionError(f"cli: traced rows {rows_d[-1:]} vs "
                             f"{rows_a[-1:]}")
    (sec_d, n_d), (sec_c, n_c) = (profile_table(out)["timestep"],
                                  prof_c["timestep"])
    phase("cli", f"run D timestep {1e3 * sec_d / n_d:.4f} ms/step traced "
          f"(torch.profiler, CPU + CUDA activity) vs run C "
          f"{1e3 * sec_c / n_c:.4f} untraced, over {n_d} and {n_c} steps, "
          f"on {card}")


def read_rows(path):
    """The data rows of a diagnostics file as a float array."""
    return np.array([[float(x) for x in line.split()]
                     for line in diag_lines(path)])


def remesh_lines(out):
    """The t0ref and dtref lines of a -v run's standard output."""
    return [line.strip() for line in out.splitlines()
            if "t0ref:" in line or "dtref @it=" in line]


@contextlib.contextmanager
def step_log(torch, classes):
    """Wraps the step method of each of classes while the block runs: a
    call is timed between two synchronizes and logged as (elements,
    seconds) in rec["steps"]; rec["first"] keeps the first call's input
    state, rec["last"] the last call's output."""
    rec = {"steps": [], "first": None, "last": None}
    saved = [(cls, cls.step) for cls in classes]

    def wrap(orig):
        def step(self, state):
            if rec["first"] is None:
                rec["first"] = state
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(self, state)
            torch.cuda.synchronize()
            rec["steps"].append((self.geom.nelem, time.perf_counter() - t))
            rec["last"] = out
            return out
        return step

    for cls, orig in saved:
        cls.step = wrap(orig)
    try:
        yield rec
    finally:
        for cls, orig in saved:
            cls.step = orig


def step_segments(steps):
    """'steps a-b on E=n: median x ms/step (mean y)' for each run of steps
    on one mesh (the steps between two dtref events)."""
    out, i = [], 0
    while i < len(steps):
        j = i
        while j < len(steps) and steps[j][0] == steps[i][0]:
            j += 1
        ms = [1e3 * s for _, s in steps[i:j]]
        out.append(f"steps {i + 1}-{j} on E={steps[i][0]}: median "
                   f"{statistics.median(ms):.4f} ms/step (mean "
                   f"{statistics.mean(ms):.4f})")
        i = j
    return out


def amr_small(torch, d, card_dev):
    """Path 20: each AMR_SMALL deck through the command with -v on the card
    and on the CPU in float64: the same t0ref and dtref lines (element
    counts included, at least one), and diag rows that agree under
    card_vs_cpu's tolerances."""
    from quinoa_tpu_torch.io import write_exodus
    from quinoa_tpu_torch.mesh import box_tet_mesh

    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for name, (deck, lo, hi) in AMR_SMALL.items():
            dp, mp = (os.path.join(d, f"{name}.q"),
                      os.path.join(d, f"{name}.exo"))
            with open(dp, "w") as fh:
                fh.write(deck)
            write_exodus(mp, box_tet_mesh(*AMR_SMALL_BOX, lo=lo, hi=hi))
            rows, lines = {}, {}
            for where, device in (("card", card_dev), ("cpu", "cpu")):
                diag = os.path.join(d, f"{name}.{where}.diag")
                out = cli_run(["inciter", "-c", dp, "-i", mp, "--diag", diag,
                               "-o", os.path.join(d, f"{name}.{where}"),
                               "-b", "-v"], device, path="amr_small")
                rows[where], lines[where] = read_rows(diag), remesh_lines(out)
            ok = lines["card"] == lines["cpu"] and len(lines["cpu"]) > 0
            phase("amr_small", f"{name}: card {lines['card']}, CPU "
                  f"{lines['cpu']}: {'equal' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"amr_small: {name} remesh lines "
                                     "differ or are missing")
            nstep = int(deck.split("nstep")[1].split()[0])
            rows_card_vs_cpu("amr_small", name, rows["card"], rows["cpu"],
                             nstep)
    finally:
        torch.set_default_dtype(prev)


def amr_run(torch, dev, card, path, deck, mesh, d, per_step, per_build,
            classes):
    """One float32 run of deck on the ExodusII mesh through the command on
    the card (-b -v --profile), launch counts zeroed just before and read
    just after: per_step launches of each kernel of the path a step, and
    per_build at each solver build (the first and one a changing dtref
    event), none of the others; every step of classes timed (step_log).
    Prints the remesh lines, the per-phase host seconds and the ms/step
    between events; gates: every diag row finite, CLI_NSTEP of them.
    Returns (stdout, step record, remesh lines)."""
    from quinoa_tpu_torch import kernels

    dp = os.path.join(d, f"{path}.q")
    with open(dp, "w") as fh:
        fh.write(deck)
    diag = os.path.join(d, f"{path}.diag")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with step_log(torch, classes) as rec:
        out = cli_run(["inciter", "-c", dp, "-i", mesh, "--diag", diag, "-o",
                       os.path.join(d, path), "-b", "-v", "--profile"], dev,
                      path=path)
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    lines = remesh_lines(out)
    builds = 1 + sum("dtref @it=" in line for line in lines)
    want = {k: CLI_NSTEP * per_step.get(k, 0) + builds * per_build.get(k, 0)
            for k in counts}
    phase(path, f"launches {counts}: {CLI_NSTEP} steps x {per_step} and "
          f"{builds} solver builds x {per_build}, the rebuilt solvers' "
          f"included; {wall:.1f} s in the command, on {card}")
    if counts != want:
        raise AssertionError(f"{path}: launches {counts}, expected {want}")
    rows = read_rows(diag)
    finite = bool(np.isfinite(rows).all())
    phase(path, f"{len(rows)} diag rows, finite {finite}; remesh: {lines}")
    if rows.shape[0] != CLI_NSTEP or not finite:
        raise AssertionError(f"{path}: diag rows {rows.shape}, finite "
                             f"{finite}")
    phase(path, "phases (s, entries): " + ", ".join(
        f"{k} {v[0]:.3f} {v[1]}" for k, v in profile_table(out).items()))
    for seg in step_segments(rec["steps"]):
        phase(path, seg + f", on {card}")
    return out, rec, lines


def amr_remesh(torch, dev, card):
    """Path 23: bench_amr.py's remesh leg in the port at AMR_REMESH_N^3:
    jump tags of a sharp spherical front (bench_amr.py:35-38), the
    refinement, the CG transfer, then the DiagCG solver's tables on the
    card (make_cggeom with its node plans, then DiagCGSolver's lumped
    mass and gathers), each timed to a synchronize."""
    from quinoa_tpu_torch.amr import refine_mesh, tag_edges_by_error
    from quinoa_tpu_torch.amr.refine import transfer_cg
    from quinoa_tpu_torch.inciter import DiagCGSolver
    from quinoa_tpu_torch.mesh import box_tet_mesh
    from quinoa_tpu_torch.pde.cg import CGTransport, make_cggeom
    from quinoa_tpu_torch.pde.problems import SlotCyl

    n = AMR_REMESH_N
    mesh = box_tet_mesh(n, n, n)
    x = mesh.coords
    r = np.sqrt(((x - 0.5) ** 2).sum(axis=1))
    u = np.exp(-((r - 0.3) / 0.05) ** 2)[None, :]
    sec = {}
    t = time.perf_counter()
    tags = tag_edges_by_error(mesh, u, method="jump", tol=0.2)
    sec["tag"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh2, rmap = refine_mesh(mesh, tags)
    sec["refine"] = time.perf_counter() - t
    t = time.perf_counter()
    u2 = transfer_cg(rmap, u)
    sec["transfer"] = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    geom = make_cggeom(mesh2, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    sec["make_cggeom"] = time.perf_counter() - t
    t = time.perf_counter()
    solver = DiagCGSolver(CGTransport(SlotCyl()), geom, cfl=0.8,
                          bcnodes=mesh2.all_bnodes())
    torch.cuda.synchronize()
    sec["DiagCGSolver"] = time.perf_counter() - t
    ok = u2.shape == (1, mesh2.nnode) and solver.geom.nelem == mesh2.nelem
    phase("amr_remesh", f"{n}^3: {mesh.nelem} -> {mesh2.nelem} tets, "
          f"{len(tags)} tagged edges; s: " + ", ".join(
              f"{k} {v:.4f}" for k, v in sec.items())
          + f", total {sum(sec.values()):.4f}, on {card}")
    if not ok:
        raise AssertionError("amr_remesh: transfer or rebuild sizes")


def amr_phases(torch, dev, card):
    """Paths 20-24: the small AMR decks card against CPU, then amr_dg,
    amr_cg, amr_remesh and t0ref at full width, float32."""
    import tempfile

    from quinoa_tpu_torch.inciter import DiagCGSolver
    from quinoa_tpu_torch.inciter.dg import DGSolver
    from quinoa_tpu_torch.io import write_exodus
    from quinoa_tpu_torch.mesh import box_tet_mesh

    dg_kernels = {k: 3 for k in CLI_KERNELS}
    cg_kernels = PATHS["diagcg"]
    with tempfile.TemporaryDirectory(prefix="quinoa_amr_") as d:
        amr_small(torch, d, dev)
        boxes = {}
        for n in (N_BIG, DIAGCG["diagcg"][1], T0REF_N):
            t0 = time.perf_counter()
            boxes[n] = os.path.join(d, f"box{n}.exo")
            write_exodus(boxes[n], box_tet_mesh(n, n, n))
            phase("amr", f"{n}^3 box written, "
                  f"{time.perf_counter() - t0:.1f} s")

        # 21. Sedov DG(P1) at 48^3 with the incremental dtref cycle
        _, rec, lines = amr_run(torch, dev, card, "amr_dg", AMR_DG_DECK,
                                boxes[N_BIG], d, dg_kernels, {}, [DGSolver])
        sizes = {e for e, _ in rec["steps"]}
        if not lines or len(sizes) < 2:
            raise AssertionError(f"amr_dg: no event changed the mesh "
                                 f"({lines})")

        # 22. DiagCG + FCT SlotCyl at 64^3, dtref every 4 steps
        _, rec, lines = amr_run(torch, dev, card, "amr_cg", AMR_CG_DECK,
                                boxes[DIAGCG["diagcg"][1]], d, cg_kernels,
                                DIAGCG_BUILD, [DiagCGSolver])
        if not lines or len({e for e, _ in rec["steps"]}) < 2:
            raise AssertionError(f"amr_cg: no event changed the mesh "
                                 f"({lines})")
        bounds_gate(None, rec["last"], rec["first"].u, name="amr_cg")

        # 23. bench_amr.py's remesh leg
        amr_remesh(torch, dev, card)

        # 24. t0ref: 24^3 refined 1:8 once, 11 Sedov P1 steps
        _, rec, lines = amr_run(torch, dev, card, "t0ref", T0REF_DECK,
                                boxes[T0REF_N], d, dg_kernels, {},
                                [DGSolver])
        want = 8 * 6 * T0REF_N ** 3
        sizes = {e for e, _ in rec["steps"]}
        ok = sizes == {want} and lines == [
            f"t0ref: {6 * T0REF_N ** 3} -> {want} tets"]
        phase("t0ref", f"elements {sorted(sizes)} (want {want}): "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"t0ref: {lines}, elements {sizes}")


def particles_card_vs_cpu(torch, dev):
    """Path 25, first part: PARTICLE_SMALL_STEPS float64 tracer steps of
    each velocity source (SlotCyl's rotation; random nodal and cell-mean
    momentum) on a refined 5x5x2 box on the card and on the CPU, then the
    CLI's re-homing on a further refined mesh and one more step: element
    ids equal, positions within PARTICLE_XP_ATOL."""
    from quinoa_tpu_torch.amr import refine_mesh
    from quinoa_tpu_torch.cli import _particles_remesh
    from quinoa_tpu_torch.mesh import box_tet_mesh
    from quinoa_tpu_torch.mesh.derived import gen_inpoed
    from quinoa_tpu_torch.particles import ParticleTracker, seed_particles
    from quinoa_tpu_torch.particles.tracker import (analytic_velocity,
                                                    cell_velocity,
                                                    nodal_velocity)
    from quinoa_tpu_torch.pde.problems import SlotCyl

    rng = np.random.default_rng(4)

    def refined(mesh, frac):
        edges = gen_inpoed(mesh.inpoel).astype(np.int64)
        tags = edges[rng.choice(len(edges), size=int(frac * len(edges)),
                                replace=False)]
        return refine_mesh(mesh, tags)[0]

    mesh = refined(box_tet_mesh(5, 5, 2, hi=(1.0, 1.0, 0.4)), 0.1)
    mesh2 = refined(mesh, 0.2)
    nod = np.empty((5, mesh.nnode))
    nod[0] = 1.0 + 0.5 * rng.random(mesh.nnode)
    nod[1:4] = nod[0] * rng.uniform(-1.0, 1.0, (3, mesh.nnode))
    nod[4] = 2.5
    cel = 0.1 * rng.standard_normal((5, 4, mesh.nelem))
    cel[0, 0] = 1.0 + 0.5 * rng.random(mesh.nelem)
    cel[1:4, 0] = cel[0, 0] * rng.uniform(-1.0, 1.0, (3, mesh.nelem))
    sources = {"analytic": (analytic_velocity(SlotCyl()), None, 0.09),
               "nodal": (nodal_velocity(), nod, 0.03),
               "cell": (cell_velocity(5, 4), cel.reshape(20, -1), 0.03)}
    xp0, ep0 = seed_particles(mesh, 2000, 5)
    for name, (vel, varg, dt) in sources.items():
        res = {}
        for where in (dev, "cpu"):
            tr = ParticleTracker(mesh, vel, dtype=torch.float64,
                                 device=where)
            vargs = () if varg is None else (torch.as_tensor(varg).to(where),)
            xp, ep = torch.as_tensor(xp0), torch.as_tensor(ep0)
            for k in range(PARTICLE_SMALL_STEPS):
                xp, ep = tr.advance(xp, ep, k * dt, dt, *vargs)
            moved = int((ep.cpu().numpy() != ep0).sum())
            if name == "analytic":
                pt = dict(tracker=tr, xp=xp, ep=ep)
                _particles_remesh(pt, mesh2)
                xp, ep = tr.advance(pt["xp"], pt["ep"], 0.45, dt)
            res[where] = (xp.cpu(), ep.cpu(), moved)
        (xa, ea, ma), (xb, eb, mb) = res[dev], res["cpu"]
        err = float((xa - xb).abs().max())
        ok = bool(torch.equal(ea, eb)) and err <= PARTICLE_XP_ATOL \
            and ma == mb > 0
        phase("particles", f"small f64 {name} velocity ({len(ep0)} tracers, "
              f"{PARTICLE_SMALL_STEPS} steps"
              + (", then re-homed on a refined mesh and one more step"
                 if name == "analytic" else "")
              + f") card vs CPU: ep equal {bool(torch.equal(ea, eb))}, "
              f"max|dxp| {err:.3e} (atol {PARTICLE_XP_ATOL:g}), {ma} changed "
              f"element: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"particles: {name} card vs CPU")


def tracer_run(torch, dev, card, name, cfg, mesh, solver):
    """Path 25: NPAR tracers seeded on mesh, advected with solver's flow
    for cfg.nstep float32 steps in process through the inciter command's
    own helpers (seeding, velocity source, step, dtref remesh and
    re-homing, solver rebuild), each tracer step timed between
    synchronizes.  Gates: positions finite and inside the box to 1e-6,
    every particle that moved in the last step inside its element
    (barycentric minimum >= -STUCK_TOL)."""
    from quinoa_tpu_torch import cli
    from quinoa_tpu_torch.control import build_inciter
    from quinoa_tpu_torch.particles.tracker import STUCK_TOL, barycentric

    torch.cuda.synchronize()
    t = time.perf_counter()
    pt = cli._seed_tracking(cfg, mesh, solver.system, NPAR, dev)
    torch.cuda.synchronize()
    phase(name, f"{NPAR} tracers seeded on E={mesh.nelem}, "
          f"{time.perf_counter() - t:.3f} s")
    cg = cfg.scheme in cli._CG_SCHEMES
    state = solver.initial_state(t0=cfg.t0)
    base = rmap = None
    tracer_s = []
    for it in range(1, cfg.nstep + 1):
        tprev = float(state.t)
        state = solver.step(state)
        torch.cuda.synchronize()
        xprev = pt["xp"]
        t = time.perf_counter()
        cli._particles_step(pt, state, tprev)
        torch.cuda.synchronize()
        tracer_s.append(time.perf_counter() - t)
        if cfg.dtref and it % cfg.dtfreq == 0 and it < cfg.nstep:
            t = time.perf_counter()
            changed, mesh2, base, rmap, u2 = cli._dtref_remesh(
                cfg, mesh, base, rmap, state.u.detach().cpu().numpy(), cg,
                solver.system.ncomp, None if cg else solver.geom.ndof)
            t_amr = time.perf_counter() - t
            if not changed:
                raise AssertionError(f"{name}: the dtref event at it={it} "
                                     "left the mesh as it was")
            mesh = mesh2
            t = time.perf_counter()
            cli._particles_remesh(pt, mesh)
            torch.cuda.synchronize()
            t_home = time.perf_counter() - t
            t = time.perf_counter()
            solver, _ = build_inciter(cfg, mesh, device=dev)
            st = solver.initial_state(t0=float(state.t))
            state = dataclasses.replace(
                st, u=torch.as_tensor(u2).to(device=st.u.device,
                                             dtype=st.u.dtype),
                it=state.it, dt=state.dt)
            torch.cuda.synchronize()
            phase(name, f"dtref @it={it}: -> {mesh.nelem} tets; tag, refine "
                  f"and transfer {t_amr:.3f} s, tracer re-homing (chunked "
                  f"nearest centroid + 4 x 4 hops) {t_home:.3f} s, solver "
                  f"rebuild {time.perf_counter() - t:.3f} s")
    xp, ep = pt["xp"], pt["ep"]
    lo, hi = (torch.as_tensor(mesh.coords.min(axis=0)[:, None]).to(xp),
              torch.as_tensor(mesh.coords.max(axis=0)[:, None]).to(xp))
    finite = bool(torch.isfinite(xp).all())
    inside = bool(((xp >= lo - 1e-6) & (xp <= hi + 1e-6)).all())
    lmin = torch.amin(barycentric(pt["tracker"].geom, xp, ep), dim=0)
    moved = (xp != xprev).any(dim=0)
    bad = int(((lmin < -STUCK_TOL) & moved).sum())
    ms = [1e3 * s for s in tracer_s]
    phase(name, f"tracer step median {statistics.median(ms):.4f} ms "
          f"(min {min(ms):.4f}, max {max(ms):.4f}) over {len(ms)} steps; "
          f"finite {finite}, inside the box {inside}, {int(moved.sum())} "
          f"moved in the last step, {bad} of them outside their element; "
          f"state finite {bool(torch.isfinite(state.u).all())}, on {card}")
    if not (finite and inside and bad == 0
            and bool(torch.isfinite(state.u).all())):
        raise AssertionError(f"{name}: tracer gates failed")


def particle_phase(torch, dev, card, big):
    """Path 25: the small card-vs-CPU tracer check, then NPAR tracers on
    the DiagCG SlotCyl 64^3 run (analytic velocity, one dtref event) and
    on the Sedov P1 48^3 run (cell means, big's geometry).  The tracers
    run in process through the command's helpers, so the phase needs no
    h5py (the command's --particles writes its H5Part file with h5py;
    tests/test_torch_cli.py checks that file on the CPU)."""
    import importlib.util

    from quinoa_tpu_torch.control import build_inciter, load_inciter
    from quinoa_tpu_torch.inciter.dg import DGSolver
    from quinoa_tpu_torch.mesh import box_tet_mesh, hilbert_element_reorder
    from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow
    from quinoa_tpu_torch.pde.problems import SedovBlastwave

    has_h5py = importlib.util.find_spec("h5py") is not None
    phase("particles", f"h5py {'present' if has_h5py else 'absent'}: "
          "tracers driven in process through the command's helpers")
    particles_card_vs_cpu(torch, dev)

    n = DIAGCG["diagcg"][1]
    cfg = load_inciter(AMR_SLOTCYL.format(nstep=CLI_NSTEP,
                                          dtfreq=PARTICLE_DTFREQ, extra="",
                                          sides=_FOUR))
    t = time.perf_counter()
    mesh, _ = hilbert_element_reorder(box_tet_mesh(n, n, n))
    solver, _ = build_inciter(cfg, mesh, device=dev)
    torch.cuda.synchronize()
    phase("particles", f"DiagCG SlotCyl {n}^3 built, "
          f"{time.perf_counter() - t:.1f} s")
    tracer_run(torch, dev, card, "particles_cg", cfg, mesh, solver)
    del solver

    cfg = load_inciter(CLI_DECK.format(nstep=CLI_NSTEP, interval=1))
    mesh, _ = hilbert_element_reorder(box_tet_mesh(N_BIG, N_BIG, N_BIG))
    solver = DGSolver(DGCompFlow(SedovBlastwave(), riemann_flux="hllc"),
                      big, cfl=0.5, limiter="superbeep1")
    tracer_run(torch, dev, card, "particles_dg", cfg, mesh, solver)


def walker_systems(dq, ip):
    """One walker per SDE class of quinoa_tpu_torch.diffeq, in a list of
    (name, [systems], coupled): 13 single systems and the coupled
    Position + Velocity + Dissipation family, each with an init policy.
    WrightFisher starts off the simplex (its components sum to 0.75),
    where its diffusion matrix is positive definite: on the simplex the
    matrix is singular and its square root amplifies eigh's round-off."""
    def with_init(s, policy, *args):
        s.init = lambda k, n, **kw: policy(k, n, *args, **kw)
        return s

    g2 = (ip.init_jointgaussian, [(0.3, 0.1), (0.1, 0.2)])
    beta = (ip.init_jointbeta, [(2.0, 2.0, 0.0, 1.0)])
    out = [
        ("diag_ou", [with_init(dq.DiagOrnsteinUhlenbeck(
            depvar="y", sigmasq=(0.25, 0.5), theta=(1.0, 2.0),
            mu=(0.5, -0.2)), *g2)]),
        ("ou", [with_init(dq.OrnsteinUhlenbeck(
            depvar="y", sigmasq=((0.25, 0.15), (0.15, 0.25)),
            theta=(1.0, 1.5), mu=(0.0, 0.3)), ip.init_jointcorrgaussian,
            [0.1, -0.1], [[0.2, 0.05], [0.05, 0.1]])]),
        ("beta", [with_init(dq.Beta(depvar="y", b=(1.0,), S=(0.6,),
                                    kappa=(0.1,)), *beta)]),
        ("numfracbeta", [with_init(dq.NumberFractionBeta(
            depvar="x", b=(0.4,), S=(0.5,), kappa=(0.1,), rho2=(2.0,),
            rcomma=(0.3,)), *beta)]),
        ("massfracbeta", [with_init(dq.MassFractionBeta(
            depvar="x", b=(0.4,), S=(0.5,), kappa=(0.1,), rho2=(2.0,),
            r=(0.3,)), *beta)]),
        ("mixnumfracbeta", [with_init(dq.MixNumberFractionBeta(
            depvar="x", bprime=(2.0,), S=(0.5,), kprime=(0.5,), rho2=(1.0,),
            rcomma=(0.5,)), ip.init_jointdelta,
            [[(0.05, 0.5), (0.95, 0.5)]])]),
        ("mixmassfracbeta", [with_init(dq.MixMassFractionBeta(
            depvar="x", bprime=(2.0,), S=(0.5,), kprime=(0.5,), rho2=(1.0,),
            r=(0.5,), coeff="homdecay"), *beta)]),
        ("dirichlet", [with_init(dq.Dirichlet(
            depvar="y", b=(1.0, 1.5), S=(0.4, 0.4), kappa=(0.5, 0.7)),
            ip.init_jointdelta, [[(0.3, 1.0)], [(0.3, 1.0)]])]),
        ("gendir", [with_init(dq.GeneralizedDirichlet(
            depvar="y", b=(0.1, 1.5), S=(0.3, 0.45), kappa=(0.1, 0.3),
            cij=(0.1,)), ip.init_jointdelta, [[(0.4, 1.0)], [(0.4, 1.0)]])]),
        ("mixdirichlet", [with_init(dq.MixDirichlet(
            depvar="y", b=(1.0, 1.5), S=(0.4, 0.3), kprime=(0.5, 0.7),
            rho=(3.0, 2.0, 1.0), coeff="homogeneous"),
            ip.init_jointdirichlet, [2.0, 3.0, 4.0])]),
        ("gamma", [with_init(dq.Gamma(depvar="y", b=(1.5,), S=(0.6,),
                                      kappa=(0.5,)),
                             ip.init_jointgamma, [(2.0, 0.5)])]),
        ("skew_normal", [with_init(dq.SkewNormal(
            depvar="y", T=(1.0,), sigmasq=(0.04,), lam=(2.0,)),
            ip.init_jointgaussian, [(0.0, 0.04)])]),
        ("wright_fisher", [with_init(dq.WrightFisher(
            depvar="y", omega=(0.25, 0.5, 0.25)), ip.init_jointdelta,
            [[(0.2, 0.5), (0.3, 0.5)], [(0.25, 1.0)],
             [(0.3, 0.5), (0.2, 0.5)]])]),
    ]
    return out + [("langevin", langevin_systems(dq, ip))]


def langevin_systems(dq, ip):
    """Position + Velocity + Dissipation, laid out and coupled by offset,
    with tests/test_walker.py:178-199's init policies."""
    from quinoa_tpu_torch.walker import Walker

    pos = dq.Position(depvar="x")
    vel = dq.Velocity(depvar="u", c0=2.1)
    dis = dq.Dissipation(depvar="o", c3=1.0, c4=0.25)
    systems = Walker.layout([pos, vel, dis])
    pos.velocity_offset = vel.offset
    vel.dissipation_offset = dis.offset
    dis.velocity_offset = vel.offset
    for s, gs in ((pos, [(0.0, 1.0)] * 3), (vel, [(0.0, 0.5)] * 3),
                  (dis, [(1.0, 0.01)])):
        s.init = lambda k, n, gs=gs, **kw: ip.init_jointgaussian(k, n, gs,
                                                                 **kw)
    return systems


def walker_draws(torch, dev):
    """The raw-draw gate: WALKER_DRAW bits (32 and 64 wide) and uniforms
    bit-identical on the card and the CPU, normals within
    WALKER_NORMAL_ULPS, and WALKER_GAMMA_N log-gamma draws at each of
    WALKER_GAMMA_ALPHAS bit-identical (the sampler's acceptance decisions
    the same), in both precisions."""
    from quinoa_tpu_torch.rng import threefry as tf

    k = tf.fold_in(tf.key(WALKER_SEED), 3)
    for width in (32, 64):
        a = tf.random_bits(k, WALKER_DRAW, width, dev).cpu()
        ok = torch.equal(a, tf.random_bits(k, WALKER_DRAW, width, "cpu"))
        phase("walker", f"bits{width} {WALKER_DRAW}: card "
              f"{'bit-identical to' if ok else 'DIFFERS from'} the CPU")
        if not ok:
            raise AssertionError(f"walker: {width}-bit draws differ")
    for dtype, itype in ((torch.float32, torch.int32),
                         (torch.float64, torch.int64)):
        u = tf.uniform(k, WALKER_DRAW, dtype, dev).cpu()
        uc = tf.uniform(k, WALKER_DRAW, dtype, "cpu")
        ok_u = torch.equal(u.view(itype), uc.view(itype))
        z = tf.normal(k, WALKER_DRAW, dtype, dev).cpu().view(itype)
        zc = tf.normal(k, WALKER_DRAW, dtype, "cpu").view(itype)
        ulps = int((z.to(torch.int64) - zc.to(torch.int64)).abs().max())
        exact = float((z == zc).double().mean())
        ok = ok_u and ulps <= WALKER_NORMAL_ULPS
        same = "bit-identical" if ok_u else "DIFFERS"
        phase("walker", f"{dtype}: uniform {same}, normal max {ulps} ulps "
              f"(<= {WALKER_NORMAL_ULPS}), {exact:.6f} identical: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"walker: {dtype} draws card vs CPU")
        for a in WALKER_GAMMA_ALPHAS:
            g = tf.loggamma(k, a, (WALKER_GAMMA_N,), dtype, dev).cpu()
            gc = tf.loggamma(k, a, (WALKER_GAMMA_N,), dtype, "cpu")
            ok = torch.equal(g.view(itype), gc.view(itype))
            phase("walker", f"{dtype}: loggamma alpha {a} x {WALKER_GAMMA_N}"
                  f" {'bit-identical' if ok else 'DIFFERS'}")
            if not ok:
                raise AssertionError(f"walker: {dtype} loggamma({a}) card "
                                     "vs CPU")


def walker_card_vs_cpu(torch, dev):
    """Every SDE class on the card and on the CPU, float64, npar
    WALKER_SMALL_NPAR, WALKER_SMALL_STEPS steps: rtol WALKER_RTOL (atol
    WALKER_ATOL)."""
    import quinoa_tpu_torch.diffeq as dq
    from quinoa_tpu_torch.diffeq import initpolicy as ip
    from quinoa_tpu_torch.walker import Walker

    names = [n for n, _ in walker_systems(dq, ip)]
    worst = {}
    for name in names:
        P = {}
        for where, device in (("card", dev), ("cpu", "cpu")):
            systems = dict(walker_systems(dq, ip))[name]
            if name != "langevin":
                systems = Walker.layout(systems)
            w = Walker(systems, npar=WALKER_SMALL_NPAR, dt=0.01, seed=3,
                       dtype=torch.float64, device=device)
            P[where] = w.run(WALKER_SMALL_STEPS)[0].cpu().numpy()
        a, b = P["card"], P["cpu"]
        ok = bool(np.isfinite(a).all()) and np.allclose(
            a, b, rtol=WALKER_RTOL, atol=WALKER_ATOL)
        worst[name] = float(np.max(np.abs(a - b)
                                   / np.maximum(np.abs(b), WALKER_ATOL)))
        if not ok:
            raise AssertionError(f"walker: {name} card vs CPU differ, max "
                                 f"rel {worst[name]:.3e}")
    phase("walker", f"{len(names)} walkers (the 16 SDE classes), f64, "
          f"npar {WALKER_SMALL_NPAR}, {WALKER_SMALL_STEPS} steps, card vs "
          f"CPU within rtol {WALKER_RTOL:g}: ok; max rel " + ", ".join(
              f"{n} {v:.2e}" for n, v in worst.items()))


class _WalkerSteps:
    """A walker as profile_path's solver: step(P) is one walker step."""

    def __init__(self, walker):
        self.walker = walker

    def step(self, P):
        return self.walker.run(1, P=P)[0]


def walker_cli(torch, dev, d):
    """python -m quinoa_tpu_torch walker on WALKER_DECK through cli.main
    on the card and on the CPU in float64, each in its own directory:
    the stat rows agree at their printed precision (12 digits) and the
    txt PDF has the same bins."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    rows, pdfs = {}, {}
    try:
        for where, device in (("card", dev), ("cpu", "cpu")):
            wd = os.path.join(d, f"walker_{where}")
            os.makedirs(wd)
            with open(os.path.join(wd, "w.q"), "w") as fh:
                fh.write(WALKER_DECK)
            cwd = os.getcwd()
            os.chdir(wd)
            try:
                cli_run(["walker", "-c", "w.q", "--stat", "stat.txt", "-v"],
                        device, path="walker")
            finally:
                os.chdir(cwd)
            with open(os.path.join(wd, "stat.txt")) as fh:
                rows[where] = [ln.split() for ln in fh
                               if not ln.startswith("#")]
            with open(os.path.join(wd, "f2.txt")) as fh:
                pdfs[where] = [ln.split()[:2] for ln in fh
                               if not ln.startswith("#")]
    finally:
        torch.set_default_dtype(prev)
    a = np.array(rows["card"], dtype=float)
    b = np.array(rows["cpu"], dtype=float)
    # one unit in the 12th significant digit of each printed value
    unit = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(b), 1e-300))) - 12)
    ok = (a.shape == b.shape and a.shape[0] == 5
          and bool((np.abs(a - b) <= 1.0001 * unit).all())
          and pdfs["card"] == pdfs["cpu"])
    same = sum(x == y for r, q in zip(rows["card"], rows["cpu"])
               for x, y in zip(r, q))
    bins = "equal" if pdfs["card"] == pdfs["cpu"] else "DIFFER"
    phase("walker", f"command: {a.shape[0]} stat rows, {same} of {a.size} "
          "printed values identical, the rest within one unit of the last "
          f"digit; PDF bins {bins}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"walker: command card vs CPU\n{a}\n{b}")


def walker_phase(torch, dev, card):
    """Path 26: the walker.  The raw-draw gate, every SDE class card
    against CPU, then the coupled Langevin family at WALKER_NPAR in
    float32: one warm-up chunk, WALKER_CHUNKS timed chunks of
    WALKER_CHUNK steps each followed by its moments (host clock around
    work ending in a synchronize), launch counts (no hand kernel), a
    torch.profiler window of 5 steps, and the gates: finite, mean
    dissipation > 0, each mean position within 5 sigma/sqrt(npar) of 0.
    Last, the walker command on the card and the CPU."""
    import tempfile

    import quinoa_tpu_torch.diffeq as dq
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.diffeq import initpolicy as ip
    from quinoa_tpu_torch.statistics import estimate_moments, moments_to_host
    from quinoa_tpu_torch.walker import Walker

    t_phase = time.perf_counter()
    walker_draws(torch, dev)
    walker_card_vs_cpu(torch, dev)

    systems = langevin_systems(dq, ip)
    ordinary = [(("x", c),) for c in range(3)] + [(("o", 0),)]
    central = [(("u", i), ("u", j)) for i in range(3) for j in range(i, 3)]
    w = Walker(systems, npar=WALKER_NPAR, dt=WALKER_DT, seed=WALKER_SEED,
               ordinary=ordinary, central=central, dtype=torch.float32,
               device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    P = w.initialize()
    P, _ = w.run(WALKER_CHUNK, P=P)                  # warm-up chunk
    moments_to_host(estimate_moments(P, w.offsets, ordinary, central))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WALKER_CHUNKS):
        P, _ = w.run(WALKER_CHUNK, P=P)
        mom = estimate_moments(P, w.offsets, ordinary, central)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    if any(counts.values()):
        raise AssertionError(f"walker: hand kernels launched {counts}")
    mom = moments_to_host(mom)
    nsteps = WALKER_CHUNK * WALKER_CHUNKS
    phase("walker", f"{WALKER_NPAR * nsteps / wall:.1f} particle-updates/s, "
          f"{1e3 * wall / nsteps:.3f} ms/step (float32, npar {WALKER_NPAR}, "
          f"{WALKER_CHUNKS} chunks of {WALKER_CHUNK} steps with moments, "
          f"host clock to a synchronize), launches {counts}, on {card}")
    X = P[:, :3].double()
    sigma = X.std(dim=0)
    xm = X.mean(dim=0)
    om = float(P[:, systems[2].offset].double().mean())
    ok = (bool(torch.isfinite(P).all()) and om > 0.0
          and bool((xm.abs() <= 5.0 * sigma / WALKER_NPAR ** 0.5).all()))
    phase("walker", f"finite {bool(torch.isfinite(P).all())}, <O> {om:.6e},"
          f" <X> {xm.tolist()} (5 sigma/sqrt(npar) "
          f"{(5.0 * sigma / WALKER_NPAR ** 0.5).tolist()}), moments "
          + ", ".join(f"{k}: {v:.6e}" for k, v in mom.items())
          + f": {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("walker: the 1e6 run's gates failed")
    profile_path(torch, _WalkerSteps(w), "walker", P, wall / nsteps)
    with tempfile.TemporaryDirectory() as d:
        walker_cli(torch, dev, d)
    phase("walker", f"path took {time.perf_counter() - t_phase:.1f} s")


class _Randu:
    """RANDU (x <- 65539 x mod 2^31) as the batteries' draw seam, keys
    ignored (tests/test_rngtest.py's first shim): uniforms x / 2^31,
    integers scaled uniforms.  Made a subclass of battery.Draws when
    used."""

    def __init__(self):
        super().__init__(device="cpu")
        self.state = 1

    def _raw(self, n):
        out = np.empty(n, dtype=np.int64)
        s = self.state
        for i in range(n):
            s = (65539 * s) % 2 ** 31
            out[i] = s
        self.state = s
        return out / 2 ** 31

    def uniform(self, key, shape, dtype=None):
        return self._raw(int(np.prod(shape))).reshape(shape)

    def randint(self, key, shape, minval, maxval, dtype=None):
        u = self._raw(int(np.prod(shape)))
        return (u * (maxval - minval) + minval).astype(np.int64).reshape(
            shape)


def rngtest_phase(torch, dev, card):
    """Path 27: the rngtest command on the card (SmallCrush at RNG_SEED,
    14/14 pass), SmallCrush test by test with each test's seconds split
    into draws on the card (with their copies to the host) and statistics
    on the host, its p-values against the port's CPU run (RNG_RTOL),
    RANDU through the draw seam (at least one of RANDU_SUBSET fails), and
    Crush's five scomp entries on the card's draws with their seconds.
    No hand kernel launches."""
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.rng.threefry import fold_in, key
    from quinoa_tpu_torch.rngtest import battery as bat

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = cli_run(["rngtest", "--battery", "smallcrush", "--seed",
                   str(RNG_SEED)], dev, path="rngtest")
    if not out.endswith("14/14 tests passed\n"):
        raise AssertionError("rngtest: the command's SmallCrush failed")

    bat.DRAWS.device, bat.DRAWS.x64 = dev, False
    k = key(RNG_SEED)
    card_res, tot, drw = [], 0.0, 0.0
    for i, test in enumerate(bat.SmallCrush):
        bat.DRAWS.seconds = 0.0
        t0 = time.perf_counter()
        r = test(fold_in(k, i))
        sec = time.perf_counter() - t0
        card_res.append(r)
        tot, drw = tot + sec, drw + bat.DRAWS.seconds
        phase("rngtest", f"{r.name}: p {r.pvalue!r} "
              f"{'pass' if r.passed else 'FAIL'}, {sec:.4f} s: draws on "
              f"the card {bat.DRAWS.seconds:.4f} s, statistics on the host "
              f"{sec - bat.DRAWS.seconds:.4f} s")
    phase("rngtest", f"SmallCrush {tot:.3f} s: draws on the card "
          f"{drw:.3f} s, statistics on the host {tot - drw:.3f} s, on "
          f"{card}")
    t0 = time.perf_counter()
    cpu_res, _ = bat.run_battery(seed=RNG_SEED, device="cpu")
    cpu_s = time.perf_counter() - t0
    a = np.array([r.pvalue for r in card_res])
    b = np.array([r.pvalue for r in cpu_res])
    ok = ([r.name for r in card_res] == [r.name for r in cpu_res]
          and all(r.passed for r in card_res)
          and np.allclose(a, b, rtol=RNG_RTOL, atol=0.0))
    phase("rngtest", f"card vs CPU ({cpu_s:.3f} s on the host): "
          f"{int((a == b).sum())} of {len(a)} p-values identical, max rel "
          f"{float(np.max(np.abs(a - b) / np.abs(b))):.3e} (rtol "
          f"{RNG_RTOL}), {sum(r.passed for r in card_res)}/14 pass: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"rngtest: card {a} vs CPU {b}")

    seam = bat.DRAWS
    bat.DRAWS = type("Randu", (_Randu, bat.Draws), {})()
    try:
        res, failed = bat.run_battery(
            seed=0, battery=[getattr(bat, n) for n in RANDU_SUBSET],
            device="cpu")
    finally:
        bat.DRAWS = seam
    phase("rngtest", "RANDU through the seam: " + ", ".join(
        f"{r.name} {r.pvalue:.3e}" for r in res)
        + f": failed {failed}: {'ok' if failed else 'FAIL'}")
    if not failed:
        raise AssertionError("rngtest: RANDU passed every test")

    bat.DRAWS.device, bat.DRAWS.x64 = dev, False
    k = key(SCOMP_SEED)
    names = ("linear_comp_jump", "linear_comp_size", "lempel_ziv")
    total = 0.0
    for i, test in enumerate(bat.Crush):
        if not set(names) & set(test.__code__.co_names):
            continue
        bat.DRAWS.seconds = 0.0
        t0 = time.perf_counter()
        r = test(fold_in(k, i))
        sec = time.perf_counter() - t0
        total += sec
        if not np.isfinite(r.pvalue):
            raise AssertionError(f"rngtest: Crush[{i}] {r}")
        phase("rngtest", f"Crush[{i}] {r.name}: p {r.pvalue!r} "
              f"{'pass' if r.passed else 'FAIL'}, {sec:.3f} s: draws on "
              f"the card {bat.DRAWS.seconds:.3f} s, bit stream and host "
              f"library {sec - bat.DRAWS.seconds:.3f} s")
    counts = dict(kernels.launches)
    if any(counts.values()):
        raise AssertionError(f"rngtest: hand kernels launched {counts}")
    phase("rngtest", f"scomp entries {total:.3f} s; path took "
          f"{time.perf_counter() - t_phase:.1f} s on {card}")


def meshconv_phase(dev, card):
    """Path 28: a CONV_N^3 box through meshconv: gmsh -> ExodusII classic
    -> netgen, and its CONV_PIECES ExodusII pieces joined; each output has
    the box's node, element and boundary-triangle counts, its
    connectivity and its coordinates to CONV_COORD_ATOL.  fileconv runs
    where h5py imports (its netCDF-4 side)."""
    import importlib.util
    import tempfile

    from quinoa_tpu_torch.io import read_mesh, write_exodus_pieces, write_gmsh
    from quinoa_tpu_torch.mesh import box_tet_mesh

    t_phase = time.perf_counter()
    mesh = box_tet_mesh(CONV_N, CONV_N, CONV_N)
    nbt = sum(len(v) for v in mesh.bface.values())
    with tempfile.TemporaryDirectory(prefix="quinoa_conv_") as d:
        p = lambda name: os.path.join(d, name)  # noqa: E731
        t0 = time.perf_counter()
        write_gmsh(p("box.msh"), mesh)
        parts = np.arange(mesh.nelem) * CONV_PIECES // mesh.nelem
        pieces = write_exodus_pieces(p("box"), mesh, parts)
        phase("meshconv", f"{CONV_N}^3 box written as gmsh and "
              f"{CONV_PIECES} ExodusII pieces in "
              f"{time.perf_counter() - t0:.2f} s")
        for argv, out in ((["-i", p("box.msh")], "box.exo"),
                          (["-i", p("box.exo")], "box.mesh"),
                          (["-i", *pieces], "joined.exo")):
            t0 = time.perf_counter()
            cli_run(["meshconv", *argv, "-o", p(out), "-v"], dev,
                    path="meshconv")
            sec = time.perf_counter() - t0
            m = read_mesh(p(out))
            err = float(np.abs(m.coords - mesh.coords).max())
            got = (m.nnode, m.nelem, sum(len(v) for v in m.bface.values()))
            ok = (got == (mesh.nnode, mesh.nelem, nbt)
                  and np.array_equal(m.inpoel, mesh.inpoel)
                  and err <= CONV_COORD_ATOL)
            phase("meshconv", f"{out}: {sec:.2f} s, (nodes, tets, boundary "
                  f"tris) {got}, connectivity equal "
                  f"{np.array_equal(m.inpoel, mesh.inpoel)}, max |d coord| "
                  f"{err:.3e}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"meshconv: {out} differs from the box")
        if importlib.util.find_spec("h5py") is None:
            phase("meshconv", "fileconv not run: its netCDF-4 side needs "
                  "h5py, which this machine lacks")
        else:
            cli_run(["fileconv", "-i", p("joined.exo"), "-o", p("f4.exo"),
                     "-v"], dev, path="meshconv")
            cli_run(["fileconv", "-i", p("f4.exo"), "-o", p("f3.exo"),
                     "-v"], dev, path="meshconv")
            m = read_mesh(p("f3.exo"))
            if not np.array_equal(m.inpoel, mesh.inpoel):
                raise AssertionError("meshconv: fileconv round trip")
    phase("meshconv", f"path took {time.perf_counter() - t_phase:.1f} s "
          f"on {card}")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    from quinoa_tpu_torch import kernels
    from quinoa_tpu_torch.inciter.dg import DGDiagnostics, DGSolver
    from quinoa_tpu_torch.pde.dg import BC_DIRICHLET, BC_SYMMETRY
    from quinoa_tpu_torch.pde.dg import volume_rhs
    from quinoa_tpu_torch.ops.nbr_bounds import limit_vol_plain
    from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow, DGTransport
    from quinoa_tpu_torch.pde.problems import (GaussHump, SedovBlastwave,
                                               TaylorGreen)

    # full float32 matmuls (dg_initialize's einsums); TF32 is off by
    # default, set here so the run does not depend on the default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    phase("card", f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    kernels.build()
    phase("build", f"{time.perf_counter() - t0:.1f} s "
          f"({os.path.basename(kernels.library_path())})")
    from quinoa_tpu_torch.rngtest import scomp

    t0 = time.perf_counter()
    scomp.build()
    phase("build", f"scomp host library {time.perf_counter() - t0:.1f} s "
          f"({os.path.basename(scomp.library_path())})")
    entry = ""
    for line in kernels.build_log().splitlines():
        if "Compiling entry function" in line:
            # the mangled kernel name up to its template arguments' end
            entry = line.split("'")[1].split("EEv")[0] + "EE"
        elif "registers" in line or "spill" in line:
            phase("build", f"{entry}: {line.strip()}")

    system = DGCompFlow(SedovBlastwave(), riemann_flux="hllc")
    transport = DGTransport(GaussHump())
    taylor = DGCompFlow(TaylorGreen(), riemann_flux="hllc")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    big = box_geom((N_BIG,) * 3, BC_SYMMETRY, torch.float32, dev)
    hump = box_geom((N_BIG,) * 3, BC_DIRICHLET, torch.float32, dev)
    phase("kernels", f"48^3 geometries (Sedov, GaussHump): E={big.nelem} "
          f"F={big.nface}, {time.perf_counter() - t0:.1f} s on the host")
    U = torch.as_tensor(perturbed_state(big.nelem, 7)).to(torch.float32
                                                          ).to(dev)
    stats = kernel_checks(torch, big, system, U, "float32", timed=True)
    stats["face_wflux (K=4)"] = stats["face_wflux"]
    stats["basis_accum (R=5, K=4)"] = stats["basis_accum"]
    hump_solver = DGSolver(transport, hump, cfl=0.8)
    Uh = hump_solver.initial_state().u
    stats.update(face_gp_kernel_checks(torch, big, U, 5, hump, Uh,
                                       *hump_face_rows(torch, hump, Uh),
                                       "float32", timed=True))
    small = box_geom(SMALL, BC_SYMMETRY, torch.float64, dev)
    U64 = torch.as_tensor(perturbed_state(small.nelem, 11)).to(dev)
    kernel_checks(torch, small, system, U64, "float64", timed=False)
    hump_small = box_geom(HUMP_SMALL, BC_DIRICHLET, torch.float64, dev)
    Uh64 = DGSolver(transport, hump_small).initial_state().u
    face_gp_kernel_checks(torch, small, U64, 5, hump_small, Uh64,
                          *hump_face_rows(torch, hump_small, Uh64),
                          "float64", timed=False)
    t0 = time.perf_counter()
    p2 = p2_geom((N_P2,) * 3, torch.float32, dev)
    phase("kernels", f"32^3 P2 geometry (TaylorGreen): E={p2.nelem} "
          f"F={p2.nface}, {time.perf_counter() - t0:.1f} s on the host")
    p2_solver = DGSolver(taylor, p2, cfl=0.5, limiter=None)
    U2 = p2_solver.initial_state().u
    rec = single_stream_checks(torch, p2, taylor, U2,
                               volume_rhs(taylor, p2, U2), "float32",
                               timed=True)
    stats["face_wflux (K=10)"] = rec["face_wflux"]
    stats["basis_accum (R=5, K=10)"] = rec["basis_accum"]
    p2_small = p2_geom(P2_SMALL, torch.float64, dev)
    U2s = DGSolver(taylor, p2_small).initial_state().u
    single_stream_checks(torch, p2_small, taylor, U2s,
                         volume_rhs(taylor, p2_small, U2s), "float64",
                         timed=False)
    taylor_lf = DGCompFlow(TaylorGreen(), riemann_flux="laxfriedrichs")
    single_stream_checks(torch, p2_small, taylor_lf, U2s,
                         volume_rhs(taylor_lf, p2_small, U2s), "float64",
                         timed=False)
    # K12 + K13 at (1, 1); K14 + K13 at its R rows (paths 12-14); the
    # Lax-Friedrichs K12 and the THINC K14 (paths 16-17)
    t0 = time.perf_counter()
    mmg = {name: mm_geom(name, (N_BIG,) * 3, torch.float32, dev)
           for name in ("p0", "mm_p1", "mm_iface", "mm_thinc",
                        "mm_iface_p1")}
    mmg["mm_p0"] = mmg["p0"]
    mmg["p1_lf"] = mmg["mm_p1"]
    mm = {name: mm_solver(name, mmg[name]) for name in MM}
    phase("kernels", "48^3 P0/multimat geometries: " + ", ".join(
        f"{name} ndof {g.ndof} E={g.nelem} F={g.nface}"
        for name, g in mmg.items()) + f", {time.perf_counter() - t0:.1f} s "
        "on the host")
    Up0 = torch.as_tensor(perturbed_state(mmg["p0"].nelem, 23, K=1)).to(
        torch.float32).to(dev)
    rec = single_stream_checks(torch, mmg["p0"], mm["p0"].system, Up0, None,
                               "float32", timed=True)
    stats["face_wflux (K=1)"] = rec["face_wflux"]
    stats["basis_accum (R=5, K=1)"] = rec["basis_accum"]
    rec = mm_kernel_checks(torch, mm["mm_p0"], "float32", timed=True)
    stats["mm_face_wflux"] = rec["mm_face_wflux"]
    stats["basis_accum (R=16, K=1)"] = rec["basis_accum"]
    rec = mm_kernel_checks(torch, mm["mm_p1"], "float32", timed=True)
    stats["mm_face_wflux (K=4)"] = rec["mm_face_wflux"]
    stats["basis_accum (R=16, K=4)"] = rec["basis_accum"]
    # nmat 3 (R = 22) on the Sod tube's faces: no path runs it fused
    mm_kernel_checks(torch, mm_solver("mm_p0", mmg["p0"], nmat=3),
                     "float32", timed=True)
    # K4 at mm_p1's 9 components, K5 and K6 at mm_iface's 12 and 22 rows
    rec = mm_face_gp_checks(torch, mm["mm_p1"], mm["mm_iface"], "float32",
                            timed=True)
    stats["nbr_bounds (C=9, K=4)"] = rec["nbr_bounds"]
    stats["face_gather (R=12)"] = rec["face_gather"]
    stats["face_accum (R=22)"] = rec["face_accum"]
    lf = mm["p1_lf"]
    ulf, rvlf = limit_vol_plain(lf.system, lf.geom, sod_perturbed(torch, lf))
    rec = single_stream_checks(torch, lf.geom, lf.system, ulf, rvlf,
                               "float32", timed=True)
    stats["face_wflux_lf"] = stats["face_wflux LF (K=4)"] = rec["face_wflux"]
    rec = mm_kernel_checks(torch, mm["mm_thinc"], "float32", timed=True)
    stats["mm_face_wflux_thinc"] = rec["mm_face_wflux_thinc"]
    stats["mm_face_wflux THINC (nmat 3, K=4)"] = rec["mm_face_wflux_thinc"]
    stats["basis_accum (R=22, K=4)"] = rec["basis_accum"]
    stats["nbr_bounds (C=12, K=4)"] = nbr_bounds_check(
        torch, mm["mm_thinc"], "float32", timed=True)
    # K5 at 108 and 48 rows, K6 at 88 rows (path 18)
    stats.update(mm_iface_p1_checks(torch, mm["mm_iface_p1"], "float32",
                                    timed=True))
    sm = {name: mm_solver(name, mm_geom(name, MM_SMALL, torch.float64, dev))
          for name in MM}
    U64p0 = torch.as_tensor(perturbed_state(sm["p0"].geom.nelem, 29,
                                            K=1)).to(dev)
    single_stream_checks(torch, sm["p0"].geom, sm["p0"].system, U64p0, None,
                         "float64", timed=False)
    for name in ("mm_p0", "mm_p1"):
        mm_kernel_checks(torch, sm[name], "float64", timed=False)
    mm_face_gp_checks(torch, sm["mm_p1"], sm["mm_iface"], "float64",
                      timed=False)
    mm_kernel_checks(torch, mm_solver("mm_p0", sm["mm_p0"].geom, nmat=3),
                     "float64", timed=False)
    lf64 = sm["p1_lf"]
    single_stream_checks(torch, sm["p0"].geom, lf64.system, U64p0, None,
                         "float64", timed=False)
    single_stream_checks(torch, lf64.geom, lf64.system,
                         *limit_vol_plain(lf64.system, lf64.geom,
                                          sod_perturbed(torch, lf64)),
                         "float64", timed=False)
    for nmat in (2, 3):
        mm_kernel_checks(torch, mm_solver("mm_thinc", sm["mm_thinc"].geom,
                                          nmat=nmat), "float64", timed=False)
    mm_iface_p1_checks(torch, sm["mm_iface_p1"], "float64", timed=False)
    t0 = time.perf_counter()
    alecg = {name: alecg_solver(name, (N_BIG,) * 3, torch.float32, dev)
             for name in ALECG}
    phase("kernels", f"48^3 ALECG solvers (SlotCyl, VorticalFlow): N="
          f"{alecg['alecg'].geom.nnode} E={alecg['alecg'].geom.nelem} "
          f"nE={alecg['alecg'].edget.edges.shape[1]} nsup D="
          f"{alecg['alecg'].geom.nsup.shape[0]} ensup D="
          f"{alecg['alecg'].edget.ensup.shape[0]}, "
          f"{time.perf_counter() - t0:.1f} s on the host")
    for name in ALECG:
        # K9 reports its time at the transport leg's row count, and at
        # alecg_cf's 5 rows as an instance
        recs = alecg_kernel_checks(torch, alecg[name], "float32", timed=True)
        if name == "alecg_cf":
            stats["cg_assemble (R=5)"] = recs.pop("cg_assemble")
        for k, v in recs.items():
            stats.setdefault(k, v)
        for n in (ALECG_SMALL[name][0], ALECG_TAIL):
            alecg_kernel_checks(torch, alecg_solver(name, n, torch.float64,
                                                    dev), "float64",
                                timed=False)
        alecg_kernel_checks(torch, alecg_solver(name, ALECG_TAIL,
                                                torch.float32, dev),
                            "float32", timed=False)
    # K7 and K8 at three rows: SlotCyl with three components
    alecg_kernel_checks(torch, alecg_solver("alecg", (N_BIG,) * 3,
                                            torch.float32, dev, ncomp=3),
                        "float32", timed=False)
    alecg_kernel_checks(torch, alecg_solver("alecg", ALECG_SMALL["alecg"][0],
                                            torch.float64, dev, ncomp=3),
                        "float64", timed=False)
    t0 = time.perf_counter()
    diagcg = {name: diagcg_solver(name, torch.float32, dev)
              for name in DIAGCG}
    phase("kernels", "DiagCG solvers: " + "; ".join(
        f"{name} N={s.geom.nnode} E={s.geom.nelem} nsup D="
        f"{s.geom.nsup.shape[0]} Dirichlet nodes "
        f"{int(s.bcmask[0].sum())}" for name, s in diagcg.items())
        + f", {time.perf_counter() - t0:.1f} s on the host")
    for name in DIAGCG:
        # K10 reports its time at the transport leg's shape; K11 at each
        # instance of both legs, the transport leg's rhs sums as its main
        # entry
        recs = diagcg_kernel_checks(torch, diagcg[name], "float32",
                                    timed=True)
        gather = recs.pop("node_gather")
        if name == MAIN_PATH["node_assemble"]:
            stats["node_gather"] = gather
            stats["node_assemble"] = recs.pop("node_assemble (R=2)")
        stats.update(recs)
        diagcg_kernel_checks(torch, diagcg_solver(name, torch.float64, dev,
                                                  small=True),
                             "float64", timed=False)

    geoms = {}

    def geom(name, device):
        if (name, device) not in geoms:
            where = dev if device == "card" else "cpu"
            if name == "p2":
                geoms[name, device] = p2_geom(P2_SMALL, torch.float64, where)
            else:
                bc = BC_SYMMETRY if name == "sedov" else BC_DIRICHLET
                n = SMALL if name == "sedov" else HUMP_SMALL
                geoms[name, device] = box_geom(n, bc, torch.float64, where)
        return geoms[name, device]

    card_vs_cpu(torch, "sedov_p1", lambda d: DGSolver(
        system, geom("sedov", d), cfl=0.5, limiter="superbeep1"))
    card_vs_cpu(torch, "sedov_pdg", lambda d: DGSolver(
        system, geom("sedov", d), cfl=0.5, limiter="superbeep1", pref=True))
    card_vs_cpu(torch, "gausshump", lambda d: DGSolver(
        transport, geom("hump", d), cfl=0.8))
    card_vs_cpu(torch, "gausshump_pdg", lambda d: DGSolver(
        transport, geom("hump", d), cfl=0.8, pref=True))
    card_vs_cpu(torch, "taylorgreen_p2", lambda d: DGSolver(
        taylor, geom("p2", d), cfl=0.5))
    for name in ALECG:
        card_vs_cpu(torch, name, lambda d, name=name: alecg_solver(
            name, ALECG_SMALL[name][0], torch.float64,
            dev if d == "card" else "cpu"))
    for name in DIAGCG:
        card_vs_cpu(torch, name, lambda d, name=name: diagcg_solver(
            name, torch.float64, dev if d == "card" else "cpu", small=True))
    for name in MM:
        card_vs_cpu(torch, name, lambda d, name=name: mm_solver(
            name, mm_geom(name, MM_SMALL, torch.float64,
                          dev if d == "card" else "cpu")))
    for name in SCHEMES:
        card_vs_cpu(torch, name, lambda d, name=name: scheme_solver(
            torch, name, d), t0=SCHEMES[name][8])

    # 4. the Sedov P1 step
    counts = {}
    solver = DGSolver(system, big, cfl=0.5, limiter="superbeep1")
    state, counts["p1"], wall = drive(torch, solver, "p1", card)
    diag = DGDiagnostics(system, big)
    phase("p1", f"L2(sol) from initial_state(): {diag.compute(state)[0]}")
    profile_path(torch, solver, "p1", state, wall / NSTEPS)

    # the L2 gate, from the known-good's own initial state
    gate = dataclasses.replace(solver.initial_state(),
                               u=tpu_precision_initial_u(solver, torch))
    gate = solver.nsteps(gate, NSTEPS + 1)
    if not bool(torch.isfinite(gate.u).all()):
        raise AssertionError("non-finite gate state after 11 steps")
    l2sol, _, _ = diag.compute(gate)
    with open(os.path.join(REPO, "tools", "bench_l2_known_good.json")) as fh:
        good = json.load(fh)["l2sol"]
    ok = np.allclose(l2sol, good, rtol=L2_RTOL, atol=0.0)
    phase("p1", f"L2(sol) from the known-good's initial state {l2sol} "
          f"vs {good}: {'ok' if ok else 'FAIL'} (rtol {L2_RTOL}, max rel "
          f"{max(abs(a - b) / abs(b) for a, b in zip(l2sol, good)):.3e})")
    if not ok:
        raise AssertionError("L2(sol) gate failed")

    # 5. the p-adaptive Sedov step
    solver = DGSolver(system, big, cfl=0.5, limiter="superbeep1", pref=True)
    state, counts["pdg"], wall = drive(torch, solver, "pdg", card)
    n4 = int((state.ndofel == 4).sum())
    if not 0 < n4 < big.nelem:
        raise AssertionError(f"pdg: {n4} of {big.nelem} elements at P1, "
                             "expected a mix of P0 and P1")
    phase("pdg", f"P1 share {n4 / big.nelem:.6f} ({n4} of {big.nelem} "
          f"elements), L2(sol) {DGDiagnostics(system, big).compute(state)[0]}")
    profile_path(torch, solver, "pdg", state, wall / NSTEPS)

    # 6. GaussHump transport on the face Gauss-point path
    state, counts["hump"], _ = drive(torch, hump_solver, "hump", card)
    l2sol, l2err, _ = DGDiagnostics(transport, hump).compute(state)
    phase("hump", f"L2(sol) {l2sol[0]:.9e}, L2(err) {l2err[0]:.9e}")
    if not l2err[0] < 0.5 * l2sol[0]:
        raise AssertionError("hump: L2(err) >= 0.5 L2(sol)")

    # 7-8. ALECG SlotCyl transport and VorticalFlow Euler
    for name in ALECG:
        state, counts[name], _ = drive(torch, alecg[name], name, card)
        l2_gate(name, alecg[name], state)

    # 9-10. DiagCG + FCT SlotCyl transport at 64^3, VorticalFlow at 48^3
    for name, solver in diagcg.items():
        u0 = solver.initial_state().u
        state, counts[name], wall = drive(torch, solver, name, card)
        l2_gate(name, solver, state)
        if name == "diagcg":
            bounds_gate(solver, state, u0)
        profile_path(torch, solver, name, state, wall / NSTEPS)

    # 11. DG(P2) TaylorGreen at 32^3
    state, counts["p2"], wall = drive(torch, p2_solver, "p2", card)
    l2_gate("p2", p2_solver, state)
    state = profile_path(torch, p2_solver, "p2", state, wall / NSTEPS)
    p2_breakdown(torch, p2_solver, state)

    # 12-18. DG(P0) Sod, the multimat paths, Lax-Friedrichs Sod DG(P1)
    # and THINC interface advection (extrapolate and Dirichlet faces) at
    # 48^3
    for name, solver in mm.items():
        state, counts[name], wall = drive(torch, solver, name, card)
        l2_gate(name, solver, state)
        if name not in EULER:
            alpha_gate(name, solver, state)
        state = profile_path(torch, solver, name, state, wall / NSTEPS)
        if name in ("mm_p1", "mm_thinc", "mm_iface_p1"):
            mm_breakdown(torch, solver, name, state)

    # 19. the main path through the port's inciter command
    cli_phase(torch, dev, card, big)

    # 20-24. mesh refinement through the inciter command; 25. tracers
    amr_phases(torch, dev, card)
    particle_phase(torch, dev, card, big)

    # 26. the walker: no hand kernel (PATHS["walker"])
    walker_phase(torch, dev, card)

    # 27. the rngtest command and batteries; 28. meshconv (no hand kernel)
    rngtest_phase(torch, dev, card)
    meshconv_phase(dev, card)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms")
    rows = [(name, name, MAIN_PATH[name]) for name in KERNELS]
    print(json.dumps({"kernels": [
        {"name": entry, "route": "cuda", "source": KERNELS[counter][0],
         "replaces": (path != "p2" and NEARFAR.get(counter)
                      or KERNELS[counter][1]),
         "launches": counts[path][counter],
         **{k: stats[entry][k] for k in keys}}
        for entry, counter, path in rows + list(INSTANCES)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
