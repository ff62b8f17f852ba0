#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (megba_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--profile]

Phases, in order; none catches its own failure, so any mismatch or
exception ends the run with a non-zero exit code:

1. build: every CUDA source of megba_tpu_torch/csrc with nvcc for sm_90a
   (all sources started together), and print the build time and each
   kernel instantiation's registers, shared memory and spill bytes (the
   kernel-1 instantiations, every one that spills and each library's
   widest in the log, the whole table in
   chiprun_out/nvcc_resources.txt);
2. the card's name and power limit, as nvidia-smi gives them;
3. kernels: at the venice shapes, each of the eight kernels on each side
   or direction it runs on (camera d=9, point d=3) at f32, and the
   bf16-row arms (mixed: rows upcast before the multiply, beside an f32
   table; mixed64: the same beside an f64 table; bf16: bf16 products, f32
   sums) of the coupling and fused kernels as rows of their own, each
   against its plain PyTorch version on the same inputs, a bitwise
   repeat, and CUDA-event medians of the kernel, the plain version and,
   where one exists, one PyTorch library call that computes the same
   function (a cuSPARSE CSR product, `torch.segment_reduce`,
   `index_select`, an einsum); kernels 7 and 8 (the fused coupling
   applies) print each direction with its share of its bound, and run
   at f32 on a heavy-tailed graph too (~1e6 slots, Zipf track lengths,
   `io.synthetic.heavy_tailed_graph`; pt->cam also over 40,000 cameras,
   short enough for slot tiles), checked and timed as sides of their
   own, outside the row's totals, as are kernels 1 and 3 on that graph's
   camera side, and as is kernel 4, at f32 and f64, on that graph's
   point side (Zipf tracks of 256 slots and more on a short side) and
   camera side and on the long cameras (split); each side's launch
   shape of kernels 1 and 3 (a thread per segment, or split segments and
   their chunk count) and of kernel 4 (slot tiles and their count beside
   the split chunks of the segments over SPLIT_ABOVE slots, a thread per
   segment where all are under 256 slots, or split chunks) is logged,
   and every kernel-4 side's most slots a block and a thread, read off
   the plan's tables, is held to `segtiles.SEG_REDUCE_BOUNDS` of its
   shape;
   kernels 8 and 7 in the 2-D mesh's
   ring-step form (`fused_ring_step_apply`, `_implicit`) on the first
   bucket of device (0, 0) of the venice 2 x 2 camera-tile plan; and the
   f64 arm of kernels 1-5 (rows `name[f64]`, the arm of ProblemOption(),
   solve_bal's default solve);
4. engines: at the venice shapes, f64, the AUTODIFF (reverse mode) and
   AUTODIFF_FORWARD (forward mode) Jacobian engines against the
   ANALYTICAL one per edge (r, Jc, Jp each within 1e-9 of the row's
   largest magnitude), with cameras under the small-angle threshold
   among the edges; then at f32 the CUDA-event time of one
   linearisation (gathers, engine and weighting) per mode and its peak
   memory.  No kernel of the port runs here;
5. f64: a trafalgar-sized scene solved end to end (`F64_LM` LM
   iterations) on twenty-two paths (IMPLICIT, EXPLICIT, each unfused
   and fused, each in full f64 and with mixed_precision_pcg; the
   reference's default solve, `implicit_autodiff`;
   `explicit_fused_autodiff_forward`;
   `implicit_fused_huber` and `explicit_cauchy`; `implicit_forcing_warm`,
   Eisenstat-Walker forcing with warm starts; guards on a clean run
   (`implicit_guarded`, bitwise the `implicit` run), with a NaN burst
   (`implicit_nan_burst`, RECOVERED), with a persistent burst
   (`implicit_fatal`, FATAL_NONFINITE), with an Hll crush
   (`explicit_fused_indefinite`, PCG breakdowns;
   `implicit_fused_schur_diag_indefinite`, counted SCHUR_DIAG
   fallbacks); the plain full-system solver (`implicit_plain`,
   `explicit_plain_forcing_warm`); COOBS on shuffled edges
   (`implicit_coobs`); NEUMANN of order 2 (`implicit_neumann`)), each
   through the kernels and through the plain versions, both on the card;
   the two cost trajectories agree at rtol 1e-9 where finite (except a
   step the guards rolled back, whose gap is printed) and are NaN at the
   same iterations, with the same accept, recovery, breakdown and
   fallback traces, counts, status and recoveries, and the kernel run's
   launches are exactly what the code implies; then the camera-graph
   coarse spaces on the scene's grid twin (`locality="grid"`), seven
   paths: TWO_LEVEL on IMPLICIT and on EXPLICIT fused, MULTILEVEL on
   IMPLICIT fused and smoothed on EXPLICIT, TWO_LEVEL with fixed
   cameras, under a NaN burst (RECOVERED) and with a NaN camera (every
   coarse level flagged, FATAL_NONFINITE), held to the same gates and,
   run twice through the kernels, bitwise equal; two plain runs of
   `implicit_neumann` and `explicit_fused` must be bitwise equal (the
   plain versions sum in a fixed order); then the multi-device paths,
   every shard on the one card: the 1-D mesh at world 2 (IMPLICIT,
   EXPLICIT, a guarded NaN burst, TWO_LEVEL on the grid twin) and the
   2 x 2 camera x edge mesh (IMPLICIT unfused, IMPLICIT and EXPLICIT
   fused), each under the same gates and also against its world-1 path
   at rtol 1e-9 with equal counts, with its launches per shard;
6. f32 precision: the same scene at f32 on the eight precision-rung
   paths (IMPLICIT / EXPLICIT, unfused / fused, mixed / bf16), kernels
   against plain versions on the card: the first LM iteration's trial
   cost at rtol 1e-4 (mixed) or 2e-2 (bf16, whose recurrence is not
   linear), the final cost at rtol 1e-3, both finite and below the
   initial;
7. venice: the venice configuration (1778 cameras, 993,923 points,
   ~5.0M observations, f32, ANALYTICAL) through `flat_solve`, the port's
   main path, once per path: IMPLICIT, EXPLICIT, EXPLICIT + fused
   kernels, IMPLICIT + fused kernels, the eight precision-rung paths,
   then IMPLICIT with AUTODIFF, with AUTODIFF_FORWARD, with a Huber loss,
   with forcing and warm starts, with guards (bitwise the IMPLICIT run),
   with guards and a NaN burst on 64 edges (RECOVERED), with the plain
   full-system solver, with SCHUR_DIAG (no fallback on a clean run) and
   with COOBS on shuffled edges, then the multi-device
   paths on the one card (world-2 IMPLICIT; 2 x 2 IMPLICIT fused,
   EXPLICIT fused, and IMPLICIT fused with bf16 and bf16 collectives),
   each run under the profiler (device busy share) with its launches per
   shard,
   its final cost within rtol 1e-3 of the IMPLICIT run's (the bf16 path
   within 2e-2).  IMPLICIT and its guarded twin run 8 LM iterations,
   every other venice path `VENICE_LM`.  A world-N wall here is N
   shards' launches queued on one card, not a scaling number.  Every
   kernel's launch
   count is read from its path's run alone and checked against the count
   the code implies; the final cost must be finite and below the (clean)
   initial, and on the autodiff and COOBS paths within rtol 1e-3 of the
   ANALYTICAL IMPLICIT run's;
8. locality: venice's cameras and observations a point on a grid of
   camera stations, cut to 200,000 points (`LOCALITY`), through JACOBI
   and the three coarse paths (TWO_LEVEL, MULTILEVEL and smoothed
   TWO_LEVEL, with the host seconds of their cluster plan and the
   CUDA-event time of each preconditioner build; no coarse level may
   fall back), with the venice options and again with a relative PCG
   tolerance: the coarse paths' final costs within rtol 1e-3 of
   JACOBI's, their PCG counts, walls and final costs side by side;
9. factors: the registered families beside BAL (planar, rig,
   pinhole_radial, pose_prior) through `flat_solve(factor=...)`: on a
   trafalgar-sized scene of each at f64 (`family_option`: AUTODIFF,
   ProblemOption()'s PCG, `DEFAULT_LM_CAP`), kernels against plain
   versions under the f64 gates, on the default path and on EXPLICIT,
   IMPLICIT and EXPLICIT with fused kernels, SCHUR_DIAG, TWO_LEVEL and
   fused mixed (`FAMILY_F64_PATHS`), and the rig on the 2 x 2 mesh with
   fused kernels (the ring step at its shapes; also held to its world-1
   run); at f32 on the same scene the fused mixed and bf16 rungs,
   kernels against plain versions under phase 6's rules, and EXPLICIT
   unfused and fused through the kernels; on a venice-scale scene of
   each (`FAMILY_VENICE`) an f32 solve with the venice options,
   AUTODIFF and no fused kernels, and another with fused IMPLICIT
   kernels, `VENICE_LM` LM iterations each (wall, LM / PCG, peak, final
   cost below the initial; the unfused one run under torch.profiler,
   with its device busy share); launches per
   kernel, block shape and arm as the code implies on every run
   (`check_family_launches`); kernel rows `name(shape)` /
   `name(shape)[f64]` of kernels 1-3 at each new (od, d) and of kernels
   4-8 at each new width or (cd, pd, od) on the venice-scale scenes
   (and kernel 4 on the pose prior's one 200,000-slot point, F = 3,
   `seg_reduce(3)`, with device times),
   held to the plain versions (f32 against the plain version in f64,
   f64 also within 1e-9 of the row's largest magnitude); then the
   Problem facade on the trafalgar-sized BAL scene: CameraVertex /
   PointVertex / default edges solve bitwise to `flat_solve` on the same
   arrays, and a custom forward() on a 6-dof pose camera (focal and
   distortion as edge constants; kernels 1-3 at (2, 6), kernel 7 at
   (6, 3, 2) with fused kernels) kernels against plain versions at f64,
   and once at f32, unfused and fused; and a pan-tilt camera edge of
   five parameters, whose kernels (1-3 at (2, 5), 7 at (5, 3, 2), 6 at
   5) are built at first use, fused, kernels against plain at f64;
10. pose graphs: the pose-graph driver (`models/pgo.solve_pgo`), whose
   sums run through kernels 1-3 at (6, 6) (SE(3)) or (7, 7) (sim(3)) and
   kernel 6 at 6 or 7: on 4,096-pose graphs at f64 (`ProblemOption()`
   under `PGO_SMALL_LM`) SE(3), sim(3), Huber, priors and world 2 on
   the one card, kernels against plain versions (trial costs at rtol
   1e-9, equal counts and status, poses within 1e-9 of their magnitude;
   world 2 also against world 1); a g2o file with EDGE_SE3_PRIOR
   records through `solve_g2o`, bitwise `solve_pgo` on the arrays read
   back; at full size (`PGO_FULL`, the JAX package's PGO_SCALE.json:
   50,000 poses, 15,000 loop closures) f32 and f64 of each family under
   `solve_pgo`'s defaults with `PGO_FULL_LM` LM iterations (wall, LM /
   accept / PCG, peak, the largest translation drift from the ground
   truth before and after, the device's busy share, each solve run under
   torch.profiler, but for the SE(3) f64 one phase 11 compares with,
   which runs once more under it; gated on a finite cost below the
   initial and a smaller drift); launches as the code implies on every
   run
   (`pgo_expected_launches`); and kernel rows `name(shape) pgo` /
   `name(shape)[f64] pgo` of 1-3 (both sides) and 6 on the full-size
   plans, each carrying its launches from the full-size run of its arm;
11. durability: `solve_checkpointed` on venice f32 IMPLICIT in chunks of
   `CHUNK_BA` LM iterations against phase 7's straight run (equal counts
   and status, final cost within 1e-6, whether the stitched trial costs
   are bitwise the straight run's, launches the straight run's plus one
   linearisation a chunk boundary and `expected_launches` summed over
   the chunks; the walls, each snapshot's seconds and bytes and each
   chunk's host seconds of re-lowering); on the trafalgar-sized f64
   scene under ProblemOption() with `DEFAULT_LM_CAP`, and guarded with a
   NaN burst whose window spans a chunk boundary, kernels against plain
   versions under the f64 gates; the kill-resume worker
   (scripts/torch_killresume_worker.py) on cuda:0, SIGKILLed once its
   first snapshot lands and resumed, bitwise an uninterrupted run;
   `solve_pgo_checkpointed` on phase 10's full-size SE(3) f64 graph in
   chunks of `CHUNK_PGO` against phase 10's straight solve (equal counts
   and status, final cost within 1e-9, `pgo_expected_launches` summed
   over the chunks); pre-flight triage on a venice-sized scene with
   orphan, behind-camera and disconnected degeneracies (`TRIAGE_KNOBS`):
   REJECT raising `ProblemRejected` with no launch and no device
   allocation (its triage phase's host seconds, its report's findings), a
   REPAIR
   solve with the venice options under `VENICE_LM` (no recovery, no
   fallback, a finite cost below the initial), and a trafalgar-sized f64
   REPAIR solve
   kernels against plain versions;
12. the fleet service (`serving/`, `algo/lanes.py`): the JAX package's
   `make_fleet(1024, size_range=(128, 1024), seed=0)` (~1.6M edges)
   through `solve_many` under `ProblemOption()` at f64, then at f32, then
   on the lane-batched LM's other coupling paths (EXPLICIT, fused
   IMPLICIT, fused EXPLICIT; `FLEET_PATHS`) at f64 and, on the first
   `FLEET_F32_RERUN` problems, f32, then on the option paths
   (`FLEET_OPTION_PATHS`: IMPLICIT mixed at f64, fused EXPLICIT mixed,
   fused IMPLICIT bf16 and IMPLICIT bf16 at f32, EXPLICIT SCHUR_DIAG,
   IMPLICIT NEUMANN and the plain solver at f64) once each on the first
   `FLEET_OPTION_N` problems, under torch.profiler, their LM / PCG totals
   and walls beside IMPLICIT's at their dtype: per bucket its shape,
   lanes and problems, LM and PCG counts, wall, device busy share of the
   buckets of `FLEET_PROFILED_LANES` lanes and more (torch.profiler over
   one more run of IMPLICIT's f64 and f32 runs; the other coupling paths'
   one f64 run is the profiled one, its profiler overhead taken out)
   and launches of
   every kernel of the path (1-3 and 6; EXPLICIT 4-5 for 3; fused 7 or
   8; a rung's arms and its 2 kernel-5 gathers a solve; SCHUR_DIAG's 9
   kernel-4 launches a solve), exactly what the lanes' traces imply
   (one launch serves every lane); the fleet's wall, problems a second,
   peak memory, lane and edge fill; every cost finite and at or below
   its initial, no FATAL.  The f64 IMPLICIT fleet again with the
   observability plane armed (MEGBA_METRICS, MEGBA_TRACE, MEGBA_FLIGHT):
   bitwise the unarmed run with equal launches, its series counting
   every problem and dispatch, its Chrome trace (one `solve_bucket` span
   a dispatch) and Prometheus text written under chiprun_out/.  The first
   `FLEET_SERIAL` problems one by one through `flat_solve` and as one
   `solve_many` (problems a second each, the latter with telemetry: one
   report a problem in chiprun_out/fleet_reports.jsonl read back by the
   port's summarize, --aggregate and --fleet); on each of the eleven
   paths the first `FLEET_VS_PLAIN` under
   `ProblemOption()`'s PCG with an LM cap of 4 through the kernels and
   through the plain versions (f64: trial costs at rtol 1e-9, equal
   counts, accepts, status and `precond_fallback` traces; the f32 rungs
   phase 6's rules with its PCG, the bf16 rung under an LM cap of 2;
   every rung from trust region 1), and `FLEET_BITWISE` problems of one
   bucket each solved as a fleet of one, bitwise equal to its lane; the
   JAX package's serving
   chaos smoke at 64 problems with the flight ring armed (`FleetQueue`,
   max_batch 16, the escalation ladder: two poisoned problems RECOVERED
   at rung 1, one shed, one bucket's first dispatch failed by
   `DispatchChaos`, the clean results bitwise the closed-window
   `solve_many` control's, the ring holding the events the chaos drove),
   then the 64 from four submitter threads; and kernel rows `name fleet`
   / `name[f64] fleet` of kernels 1-5 (camera and point side), 6, and 7
   and 8 (both directions) at the largest bucket's union plan, and the
   option paths' arms there (`FLEET_ARM_ROWS`: 2 and 3 mixed64 and
   bf16, 7 bf16, 8 mixed, 6 bf16, 4 on the correction rows), with
   CUDA-event and device times, bounds and library calls, and kernel 5's
   rows against `index_select` in ten alternating pairs by device time;
13. federation (`serving/federation.py`, `worker.py`, `artifacts.py`,
   `transport.py`): the parent exports artifacts (each bucket's built
   kernel libraries) and a manifest from its own pool for the buckets of
   phase 12's fleet at f64 under `ProblemOption()`; a `FleetRouter` of
   two pipe workers whose package is a fresh copy of megba_tpu_torch/ (no
   build/ beside it) on their PYTHONPATH warms from them (each hello:
   mode "artifact", no build compiled, no nvcc at warm-up or in the first
   solve; the warm seconds beside phase 1's build seconds); all 1,024
   problems through `submit_many` / `flush`, bitwise phase 12's IMPLICIT
   f64 results (cameras, points, cost, status, counts), every problem
   counted to a worker, the workers' kernel launches (1-3 and 6) read
   back, and again past the workers' first solves; 256 problems again
   with one worker SIGKILLed at its second solve request after its first
   reply: its problems reroute to the survivor (`worker_lost` 1,
   `rerouted` >= 1, no future pending), bitwise; then two TCP workers
   dialing a `ChaosTcpProxy` in front of a router under a seeded
   `NetFaultPlan` (`FED_CHAOS`: a drop and a truncate at the first two
   handshakes, more at random) on the first 64 problems under fused
   EXPLICIT f64 (kernel 8 in the workers), bitwise phase 12's fused
   EXPLICIT f64 results, each problem solved once (resends served by the
   dedup cache), and again through a clean plan with no connection lost
   or resent. The workers share the one card, so the walls are no scaling
   number;
14. host tools: the native host library (megba_tpu_torch/native/, g++)
   must build or load, and its seconds are logged; the venice scene is
   written once with `io.bal.save_bal` and parsed natively and by the
   NumPy tokenizer (both times logged, all five arrays equal); the six
   BAL CLIs of megba_tpu_torch/examples/ run on that file with
   `HOST_CLI_ARGS` through `main(argv)` on the card, each final cost
   bitwise an in-process `flat_solve` of the parsed arrays (the native
   parser's, which must equal the NumPy tokenizer's) with the CLI's
   options, and launches exactly what phase 7's IMPLICIT or EXPLICIT
   path implies (`expected_launches`), and `HOST_CLI_SUBPROCESS` once
   more as a real subprocess, bitwise (the NumPy parse, on a thread,
   and the subprocess overlap the in-process CLIs);
   planar_demo.py at its defaults the same way; the host plan cache
   (ops/segtiles.cached_*): venice IMPLICIT f32 on a cleared cache and
   again warm (`plan_cache_hit`, bitwise: trace, cameras, points; the
   "plan" seconds of both and the cache's bytes on the card), locality
   TWO_LEVEL the same way (`cluster_plan_cache_hit`, both
   `coarse_plan_seconds`), and phase 11's chunked venice re-lowering per
   chunk beside the parent's 4.659 s; one trafalgar-sized solve under
   `utils.timing.trace_profile`, whose trace must name kernels 1-3 and
   the PhaseTimer ranges.  Every phase's lap line counts the plan-cache
   hits and misses inside it: a phase with hits re-solved a graph it had
   planned, and its walls hold those lookups in place of planning;
15. multi-process (parallel/multihost.py, robustness/elastic.py): a
   rendezvous process (`python -P -m megba_tpu_torch.parallel.multihost
   --serve 0 2`, port 0) and two rank processes of this script
   (`--rank`, `python -P`), each on cuda:0 in one gloo process group:
   15.1 venice f32 IMPLICIT at world 2 (phase 7's `w2_implicit` options
   and LM count), bitwise phase 7's one-process world-2 run (trace,
   cameras, points), each rank's launches per kernel its shard's plus
   the replicated work (`ShardLaunches`: phase 7's shard-0 tally), no
   nvcc build in a rank (they load the libraries phase 1 built); the
   wall, each rank's peak memory, the bytes gathered and the host ms in
   the gathers per LM iteration, and the backend are logged; 15.2 phase
   10's 4,096-pose f64 world-2 graph across the two ranks, bitwise its
   one-process world-2 run (poses, costs, counts, status); 15.3 the
   elastic kill-resume (`ELASTIC_*`): trafalgar-sized f64 at world 2 in
   chunks of `CHUNK_BA` under an `ElasticMonitor`, rank 1 SIGKILLed at
   rank 0's first snapshot; rank 0 must raise a typed `WorkerLost`
   within `dead_after_s` plus a few polls (the time to detection is
   logged), resume at world 1 (`resume_elastic`) and exit 0, within rtol
   1e-6 of the parent's uninterrupted world-2 run in final cost and
   parameters with equal status, its telemetry's elastic block counting
   1 worker lost, 1 reshard and 1 resume; in the ranks of 15.1 / 15.2,
   15.4 venice f32 IMPLICIT on the 2 x 2 mesh across the two ranks (two
   shards on cuda:0 a rank, phase 7's `2x2_implicit` options, `VENICE_LM`)
   and 15.5 the trafalgar-sized f64 scene on 1 x 2 (world 2, cam_blocks 2:
   one shard a rank, so every ring hop crosses), fused IMPLICIT and
   EXPLICIT, each bitwise its one-process 2-D run in the parent (trace,
   cameras, points, cost, counts), each rank's launches per shard the
   parent's tally of its shards with the replicated work on its first,
   kernels 7 and 8 in their ring-step form in both ranks of 15.5; each
   rank's wall, peak memory, gathers and ring hops (count, bytes, host
   ms) per LM iteration are logged.  A failed rank, or one alive past
   `MP_RANK_TIMEOUT_S`, fails the run;
16. audit (megba_tpu_torch/analysis/): the census of the canonical specs
   (`program_audit`) on the card, each spec's per-LM and per-PCG counts
   of host reads, collectives by kind and kernel calls by arm equal to
   the committed `audit_budget.json` (the CPU census), with the host
   synchronisations `torch.cuda.set_sync_debug_mode` reports beside
   them; the strict-dtype lane's BA and PGO solves on the card; and the
   rebuild sentinel (`analysis/retrace.py`), open from the end of phase
   1 to here: no kernel library is built after phase 1 but the three
   that phase 9's pan-tilt edge builds at first use by design
   (`FIRST_USE_LIBRARIES`), each once.

The last two lines of standard output are the `kernels` JSON object and
`{"ok": true, "device": {...}}`.  `--profile` adds a torch.profiler
pass over a second solve of each full-width path and writes its kernel
table to chiprun_out/.  Kernel 6's rows also carry torch.profiler's
device time per launch beside their einsum yardstick's (`device_ms`,
`library_device_ms`), and so do the pose prior's rows of kernels 1-3
at (6, 3) (its one-segment point side, beside cuSPARSE's for 2 and 3),
of kernel 2 at (6, 6) and of kernels 4 and 5 at F = 6 (its poses,
beside `segment_reduce`'s and `index_select`'s), and the pose-graph rows
of kernel 2 at (6, 6) and (7, 7), both arms, summed over the i- and
j-side as their CUDA-event time is.  The scenes are
fixed: a quick check of a new kernel build is the `cuda`-marked test,
`pytest -m cuda
tests/test_torch_cuda.py`.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = torch.device("cuda")

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and non-tensor-core
# float32 / float64 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# f32 kernel-vs-plain tolerance: both sum the same terms in another order,
# so |kernel - plain| is held to 1e-5 (~170 f32 ulps) of the sum of the
# terms' magnitudes, per output.
F32_REL_TO_ABS_SUM = 1e-5
# f64 kernel-vs-plain tolerance, the same rule: 1e-12 of the sum of the
# terms' magnitudes.
F64_REL_TO_ABS_SUM = 1e-12
F64_COST_RTOL = 1e-9
# f64 kernel rows are also held within this share of the row's largest
# magnitude (per output row).
F64_REL_TO_ROW_MAX = 1e-9
# The engine phase: an autodiff Jacobian against the closed form at f64,
# per edge, within this share of the row's largest magnitude.
ENGINE_REL_TO_ROW_MAX = 1e-9
# Precision-rung solves, kernels against plain versions at f32: the first
# trial cost, per rung, and the final cost (an accept decision may flip
# near the optimum at f32, so the trajectories are not compared step by
# step).  The bf16 rung rounds the gathered Krylov vector to bf16, so its
# CG is not a linear recurrence: another f32 summation order of the same
# solve moves the first trial cost by up to ~3e-3 (PERF.md section 6),
# and it is held to the JAX package's bf16 band instead
# (tests/test_bf16.py).
FIRST_COST_RTOL = {"mixed": 1e-4, "bf16": 2e-2}
FINAL_COST_RTOL = 1e-3
# The venice autodiff paths' final cost against the ANALYTICAL IMPLICIT
# run's: the same solve in f32, whose Jacobians differ in rounding.
AUTODIFF_COST_RTOL = 1e-3
# A library yardstick in bf16 (cuSPARSE with bf16 values) rounds its
# output to bf16: it is held to 2^-6 of the sum of the terms' magnitudes.
BF16_LIBRARY_REL_TO_ABS_SUM = 2.0 ** -6
# An f32 library yardstick of the factor rows, held to the f64 plain
# version: its f32 sum over one 200,000-slot segment (the pose prior's
# point side) parts from the f64 sum by more than the f32 rule.  The
# long cameras' yardstick (to 40,000 slots a camera) is held to it too.
F32_LONG_LIBRARY_REL_TO_ABS_SUM = 1e-4

VENICE = dict(num_cameras=1778, num_points=993_923,
              obs_per_point=5_001_946 / 993_923)
# The heavy-tailed graph of the kernel phase, a correctness graph for the
# slot tiles' edge cases: venice's cameras, and points whose Zipf track
# lengths (mean ~5.9) give ~1.0e6 slots.  The same points over
# HEAVY_SHORT_CAMERAS cameras (~25 slots a camera) put the pt->cam
# direction on slot tiles too.
HEAVY = dict(num_cameras=1778, num_points=170_000)
HEAVY_SHORT_CAMERAS = 40_000
# Kernels 1 and 3 also run on a camera side of this many long cameras
# (`io.synthetic.long_camera_idx`: 5,000-40,000 edges each, ~1.07e6
# slots), longer than venice's, where the split shape cuts cameras.
LONG_CAMERAS = 64
# The fused coupling kernels, whose rows print per direction.
FUSED_COUPLING = ("fused_coupling_apply", "fused_coupling_apply_implicit")
TRAFALGAR = dict(num_cameras=257, num_points=65_132,
                 obs_per_point=225_911 / 65_132)
REPLACES = {
    "jtj_grad_reduce": "megba_tpu/ops/segtiles.py:469",
    "coupling_expand": "megba_tpu/ops/segtiles.py:624",
    "coupling_reduce": "megba_tpu/ops/segtiles.py:688",
    "seg_reduce": "megba_tpu/ops/segtiles.py:279",
    "seg_expand": "megba_tpu/ops/segtiles.py:336",
    "fused_coupling_apply": "megba_tpu/ops/fused.py:500",
    "fused_coupling_apply_implicit": "megba_tpu/ops/fused.py:526",
    "fused_block_diag_apply": "megba_tpu/ops/fused.py:647",
    # Kernels 8 and 7 in the 2-D mesh's ring-step call form
    # (`fused_single_block_apply`).
    "fused_ring_step_apply": "megba_tpu/ops/fused.py:617",
    "fused_ring_step_apply_implicit": "megba_tpu/ops/fused.py:622",
}
# The solve paths of phases 4-6: (compute kind, fused_kernels, precision
# rung, the kernels the path must launch).
_BUILD = ("jtj_grad_reduce", "coupling_expand")
PATHS = {
    "implicit": ("IMPLICIT", False, None, _BUILD + ("coupling_reduce",)),
    "explicit": ("EXPLICIT", False, None,
                 _BUILD + ("seg_expand", "seg_reduce")),
    "explicit_fused": ("EXPLICIT", True, None,
                       _BUILD + ("fused_coupling_apply",
                                 "fused_block_diag_apply")),
    "implicit_fused": ("IMPLICIT", True, None,
                       _BUILD + ("fused_coupling_apply_implicit",
                                 "fused_block_diag_apply")),
}
for _kind in ("IMPLICIT", "EXPLICIT"):
    for _rung in ("mixed", "bf16"):
        PATHS[f"{_kind.lower()}_fused_{_rung}"] = (
            _kind, True, _rung, _BUILD + (
                "seg_expand", "fused_block_diag_apply",
                "fused_coupling_apply_implicit" if _kind == "IMPLICIT"
                else "fused_coupling_apply"))
for _kind in ("IMPLICIT", "EXPLICIT"):
    for _rung in ("mixed", "bf16"):
        PATHS[f"{_kind.lower()}_{_rung}"] = (
            _kind, False, _rung, _BUILD + (
                ("seg_expand", "coupling_reduce") if _kind == "IMPLICIT"
                else ("seg_expand", "seg_reduce")))
# The f64 phase's paths: the f32/f64 ones and mixed_precision_pcg (bf16
# is an f32 rung).
F64_PATHS = [p for p, (_, _, rung, _) in PATHS.items() if rung != "bf16"]
# The venice phase's paths of the kernel slices, in order.
VENICE_PATHS = list(PATHS)
# The paths of the Jacobian modes, robust losses and forcing: a path of
# the kernel slices (its kernels and launches) with option fields of its
# own.  Ceres's `bundle_adjuster --robustify` uses a Huber loss of scale
# 1; forcing runs the JAX package's INEXACT solver options
# (tests/test_forcing.py) under the phase's PCG cap.
VARIANTS = {
    "implicit_autodiff": ("implicit", dict(jacobian_mode="AUTODIFF")),
    "implicit_autodiff_forward": (
        "implicit", dict(jacobian_mode="AUTODIFF_FORWARD")),
    "explicit_fused_autodiff_forward": (
        "explicit_fused", dict(jacobian_mode="AUTODIFF_FORWARD")),
    "implicit_huber": ("implicit", dict(robust_kind="HUBER")),
    "implicit_fused_huber": ("implicit_fused", dict(robust_kind="HUBER")),
    "explicit_cauchy": ("explicit", dict(robust_kind="CAUCHY")),
    "implicit_forcing_warm": ("implicit", dict(forcing=True)),
}
for _name, (_base, _) in VARIANTS.items():
    PATHS[_name] = PATHS[_base]
F64_PATHS += ["implicit_autodiff", "explicit_fused_autodiff_forward",
              "implicit_fused_huber", "explicit_cauchy",
              "implicit_forcing_warm"]
VENICE_PATHS += ["implicit_autodiff", "implicit_autodiff_forward",
                 "implicit_huber", "implicit_forcing_warm"]
# Fault containment, the plain full-system solver, the co-observation
# edge order and the SCHUR_DIAG / NEUMANN preconditioners: a path of the
# kernel slices with option fields of its own.  `fault` names a seeded
# fault plan (`fault_plan`); `shuffle` puts the caller's edges in a
# seeded random order first, so that COOBS and NATURAL lay out different
# slot orders (the synthetic scenes come camera-sorted, where COOBS is
# almost the identity).
FAULT_VARIANTS = {
    "implicit_guarded": ("implicit", dict(guards=True)),
    "implicit_nan_burst": ("implicit", dict(guards=True, fault="nan_burst")),
    "implicit_fatal": ("implicit", dict(guards=True, fault="persistent")),
    "explicit_fused_indefinite": ("explicit_fused", dict(
        guards=True, fault="crush")),
    "implicit_fused_schur_diag_indefinite": ("implicit_fused", dict(
        guards=True, fault="crush", preconditioner="SCHUR_DIAG")),
    "implicit_plain": ("implicit", dict(use_schur=False)),
    "explicit_plain_forcing_warm": ("explicit", dict(use_schur=False,
                                                     forcing=True)),
    "implicit_coobs": ("implicit", dict(edge_order="COOBS", shuffle=True)),
    "implicit_neumann": ("implicit", dict(precond="NEUMANN")),
    "implicit_schur_diag": ("implicit", dict(preconditioner="SCHUR_DIAG")),
}
VARIANTS.update(FAULT_VARIANTS)
for _name, (_base, _extra) in FAULT_VARIANTS.items():
    _k = PATHS[_base]
    # SCHUR_DIAG sums its correction rows per camera with kernel 4.
    PATHS[_name] = _k[:3] + (_k[3] + (
        ("seg_reduce",) if _extra.get("preconditioner") == "SCHUR_DIAG"
        and "seg_reduce" not in _k[3] else ()),)
F64_PATHS += ["implicit_guarded", "implicit_nan_burst", "implicit_fatal",
              "explicit_fused_indefinite",
              "implicit_fused_schur_diag_indefinite", "implicit_plain",
              "explicit_plain_forcing_warm", "implicit_coobs",
              "implicit_neumann"]
VENICE_PATHS += ["implicit_guarded", "implicit_nan_burst", "implicit_plain",
                 "implicit_schur_diag", "implicit_coobs"]
NEUMANN_ORDER = 2
# The camera-graph coarse spaces, TWO_LEVEL and MULTILEVEL (default
# knobs: sqrt(Nc) clusters, coarsen factor 4, at most 3 levels), plain
# or smoothed (`smooth_omega`): a path of the kernel slices whose build
# sums its edge rows with kernel 4.  At f64 they run on the
# trafalgar-sized grid scene (`scene="grid"`), where the coarse space has
# structure to capture; `fixed` fixes the first cameras, `nan_camera`
# puts a NaN in one camera parameter (every system's coarse operator is
# poisoned: each level's bit is set and the guarded solve ends
# FATAL_NONFINITE).
COARSE_VARIANTS = {
    "implicit_two_level": ("implicit", dict(precond="TWO_LEVEL")),
    "explicit_fused_two_level": ("explicit_fused", dict(
        precond="TWO_LEVEL")),
    "implicit_fused_multilevel": ("implicit_fused", dict(
        precond="MULTILEVEL", max_levels=3)),
    "explicit_multilevel_smoothed": ("explicit", dict(
        precond="MULTILEVEL", smooth_omega=2 / 3)),
    "implicit_two_level_fixed": ("implicit", dict(precond="TWO_LEVEL",
                                                  fixed=4)),
    "implicit_two_level_nan_burst": ("implicit", dict(
        precond="TWO_LEVEL", guards=True, fault="nan_burst")),
    "implicit_two_level_nan_camera": ("implicit", dict(
        precond="TWO_LEVEL", guards=True, fault="nan_camera")),
    "implicit_multilevel": ("implicit", dict(precond="MULTILEVEL")),
    "implicit_two_level_smoothed": ("implicit", dict(
        precond="TWO_LEVEL", smooth_omega=2 / 3)),
}
VARIANTS.update(COARSE_VARIANTS)
for _name, (_base, _extra) in COARSE_VARIANTS.items():
    _k = PATHS[_base]
    PATHS[_name] = _k[:3] + (_k[3] + (
        () if "seg_reduce" in _k[3] else ("seg_reduce",)),)
COARSE_F64_PATHS = ["implicit_two_level", "explicit_fused_two_level",
                    "implicit_fused_multilevel",
                    "explicit_multilevel_smoothed",
                    "implicit_two_level_fixed",
                    "implicit_two_level_nan_burst",
                    "implicit_two_level_nan_camera"]
F64_PATHS += COARSE_F64_PATHS
# They run on the locality scene (`LOCALITY_PATHS`), not on venice: its
# grid gives the coarse space structure, and venice's 7-8 s of host
# union-find planning a path bought no more coverage.
COARSE_VENICE_PATHS = ["implicit_two_level", "implicit_multilevel",
                       "implicit_two_level_smoothed"]
# The multi-device solve: every shard on the one card (`device=[DEVICE] *
# world`), the 1-D edge-sharded mesh at world 2 and the 2 x 2 camera x
# edge mesh (`mesh_2d`, cam_blocks 2), whose S.p product rings the point
# shards around the camera columns: through kernels 7 or 8 in their
# ring-step form on the fused paths, through kernels 2 and 3 per bucket
# on the unfused one.  Each f64 path is also held to its world-1 path
# (`MESH_BASE`) at `F64_COST_RTOL` with equal counts; each venice path's
# final cost to the venice IMPLICIT run's at rtol 1e-3, or the bf16
# path's within the JAX package's bf16 band, 2e-2 (tests/test_bf16.py).
MESH_VARIANTS = {
    "w2_implicit": ("implicit", dict(world=2)),
    "w2_explicit": ("explicit", dict(world=2)),
    "w2_implicit_nan_burst": ("implicit", dict(world=2, guards=True,
                                               fault="nan_burst")),
    "w2_implicit_two_level": ("implicit", dict(world=2, precond="TWO_LEVEL")),
    "2x2_implicit": ("implicit", dict(world=4, mesh_2d=True)),
    "2x2_implicit_fused": ("implicit_fused", dict(world=4, mesh_2d=True)),
    "2x2_explicit_fused": ("explicit_fused", dict(world=4, mesh_2d=True)),
    "2x2_implicit_fused_bf16": ("implicit_fused_bf16", dict(
        world=4, mesh_2d=True, bf16_collectives=True)),
}
MESH_BASE = {"w2_implicit": "implicit", "w2_explicit": "explicit",
             "w2_implicit_nan_burst": "implicit_nan_burst",
             "w2_implicit_two_level": "implicit_two_level",
             "2x2_implicit": "implicit",
             "2x2_implicit_fused": "implicit_fused",
             "2x2_explicit_fused": "explicit_fused",
             "2x2_implicit_fused_bf16": "implicit"}
VARIANTS.update(MESH_VARIANTS)
for _name, (_base, _extra) in MESH_VARIANTS.items():
    _k = PATHS[_base]
    _more = ()
    if _extra.get("precond"):
        _more = ("seg_reduce",)
    if _extra.get("mesh_2d") and _k[1]:
        _more = ("fused_ring_step_apply_implicit" if _k[0] == "IMPLICIT"
                 else "fused_ring_step_apply",)
    PATHS[_name] = _k[:3] + (_k[3] + _more,)
MESH_F64_PATHS = ["w2_implicit", "w2_explicit", "w2_implicit_nan_burst",
                  "w2_implicit_two_level", "2x2_implicit",
                  "2x2_implicit_fused", "2x2_explicit_fused"]
F64_PATHS += MESH_F64_PATHS
MESH_VENICE_PATHS = ["w2_implicit", "2x2_implicit_fused",
                     "2x2_explicit_fused", "2x2_implicit_fused_bf16"]
VENICE_PATHS += MESH_VENICE_PATHS
BF16_COST_RTOL = 2e-2
# The plain versions' sums run in a fixed order: two plain runs of these
# f64 paths must be bitwise equal.
PLAIN_REPEAT_PATHS = ("implicit_neumann", "explicit_fused")

# The locality scene: venice's cameras and observations a point on a grid
# of camera stations (`locality="grid"`), where neighbouring cameras share
# points and the coarse space is live.  Cut from venice's 993,923 points
# to 200,000: the host's k-nearest-camera generator takes ~150 s at full
# size, ~32 s here.  JACOBI first, the reference of the coarse paths'
# final costs (phase 6's f32 rule).
LOCALITY = dict(VENICE, num_points=200_000, locality="grid")
LOCALITY_PATHS = ["implicit"] + COARSE_VENICE_PATHS
# LM iterations of every locality path (cut from 8 for the script's time
# limit): JACOBI's and the coarse paths' trial costs agree within 1e-5 at
# every iteration, so the 1e-3 gate between them holds at any depth.
LOCALITY_LM = 4
LOCALITY_COST_RTOL = 1e-3
# The f64 grid scene of the coarse paths.
TRAFALGAR_GRID = dict(TRAFALGAR, locality="grid")
# The NaN burst: two edges at f64 (tests/test_robustness.py:84-90), 64
# seeded edges at venice; both cover iteration 0, so the initial
# linearisation is poisoned too.  The crush: the Hll blocks of the 256
# points with the most observations, in the systems built at carry 2
# (the window of tests/test_robustness.py:176), which on the
# trafalgar-sized scene is an accepted step.
NAN_EDGES_F64 = (2, 9)
NAN_EDGES_VENICE = 64
CRUSH_POINTS = 256
CRUSH_WINDOW = (2, 3)
SHUFFLE_SEED = 7
# The venice COOBS run's final cost against the NATURAL IMPLICIT run's:
# the same solve in f32 with its sums in another order (phase 6's rule).
COOBS_COST_RTOL = 1e-3
# The reference's default solve: at f64 it runs ProblemOption()'s own
# tolerances under the phase's PCG cap and an LM cap of 5; at venice the
# phase's options, so that its final cost compares with the ANALYTICAL
# run's.  With the default PCG (absolute tol 1e-1, refuse ratio 1) the
# trafalgar-sized scene reaches its cost floor at the 8th LM iteration
# (a step of ~1e-16 relative), where an accept decision is rounding: a
# 1e-15 relative change of the observations flips it through the plain
# versions alone (ROADMAP Queue 3, "past the cost floor").  Its 5th step
# still moves the cost by ~3e-8.
DEFAULT_PATH = "implicit_autodiff"
DEFAULT_LM_CAP = 5
# The kernel rows of the bf16-row arms, and the venice path whose run
# gives each its launch count (of that arm).
ARM_PATHS = {
    "fused_coupling_apply_implicit[mixed]": "implicit_fused_mixed",
    "fused_coupling_apply_implicit[bf16]": "implicit_fused_bf16",
    "fused_coupling_apply[mixed]": "explicit_fused_mixed",
    "fused_coupling_apply[bf16]": "explicit_fused_bf16",
    "fused_block_diag_apply[bf16]": "explicit_fused_bf16",
    "coupling_expand[mixed]": "implicit_mixed",
    "coupling_reduce[mixed]": "implicit_mixed",
    "coupling_expand[bf16]": "implicit_bf16",
    "coupling_reduce[bf16]": "implicit_bf16",
}
# The mixed64 and f64 rows take theirs from the f64 phase's (trafalgar)
# run of the path: the venice phase runs f32 only.  Kernels 1-3 at f64
# count on the reference's default solve, 4 and 5 on EXPLICIT.
F64_ARM_PATHS = {
    "coupling_expand[mixed64]": "implicit_mixed",
    "coupling_reduce[mixed64]": "implicit_mixed",
    "fused_coupling_apply_implicit[mixed64]": "implicit_fused_mixed",
    "fused_coupling_apply[mixed64]": "explicit_fused_mixed",
    "jtj_grad_reduce[f64]": DEFAULT_PATH,
    "coupling_expand[f64]": DEFAULT_PATH,
    "coupling_reduce[f64]": DEFAULT_PATH,
    "seg_reduce[f64]": "explicit",
    "seg_expand[f64]": "explicit",
}


# The factor phase: the registered camera/point families beside BAL, at
# their own block shapes.  Venice scale: venice's cameras and points
# (obs_per_point 5; the rig 3 over 2 mounts), the pose prior 100,000
# poses with 2 priors each; trafalgar scale for the f64 gates.  The pose
# prior's priors carry noise 0.01: with exact priors the optimum's cost
# is ~0, where a relative gate on the costs says nothing.
FAMILIES = ("planar", "rig", "pinhole_radial", "pose_prior")
FAMILY_VENICE = {
    "planar": dict(num_cameras=1778, num_points=993_923, obs_per_point=5),
    "rig": dict(num_bodies=1778, num_points=993_923, rig_cameras=2,
                obs_per_point=3),
    "pinhole_radial": dict(num_cameras=1778, num_points=993_923,
                           obs_per_point=5),
    "pose_prior": dict(num_poses=100_000, priors_per_pose=2,
                       prior_noise=0.01),
}
FAMILY_TRAFALGAR = {
    "planar": dict(num_cameras=257, num_points=65_132, obs_per_point=4),
    "rig": dict(num_bodies=257, num_points=65_132, rig_cameras=2,
                obs_per_point=3),
    "pinhole_radial": dict(num_cameras=257, num_points=65_132,
                           obs_per_point=4),
    "pose_prior": dict(num_poses=4096, priors_per_pose=2, prior_noise=0.01),
}
# The Problem facade's custom edge: a 6-dof pose camera [angle-axis,
# t] with the focal and the distortion as edge constants, obs = [u, v, f,
# k1, k2]; its camera side runs kernels 1-3 at (2, 6).
POSE_CAMERA_BLOCK = (2, 6)
# The pose prior's rows near the launch floor, which also get
# torch.profiler's device time: kernels 1-3 on its one-segment point
# side, kernel 2 on its poses, kernels 4 and 5 on its 100,000 poses, and
# kernel 4 on its one-segment point side (F = 3, f32 and f64).
POSE_PRIOR_DEVICE_ROWS = ("jtj_grad_reduce(6,3)", "coupling_reduce(6,3)",
                          "coupling_expand(6,3)", "coupling_expand(6,6)",
                          "seg_reduce(6)", "seg_expand(6)", "seg_reduce(3)",
                          "seg_reduce(3)[f64]")


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def make_scene(cfg: dict, dtype):
    from megba_tpu_torch.io.synthetic import make_synthetic_bal

    t = time.perf_counter()
    s = make_synthetic_bal(seed=0, param_noise=1e-2, pixel_noise=0.5,
                           dtype=dtype, **cfg)
    log(f"scene: {cfg['num_cameras']} cameras, {cfg['num_points']} points, "
        f"{s.obs.shape[0]} observations, {np.dtype(dtype).name}, made in "
        f"{time.perf_counter() - t:.1f} s")
    return s


# LM iterations of a venice path other than IMPLICIT and its bitwise twin
# `implicit_guarded` (cut from 8 to bring the script under its time
# limit): IMPLICIT's cost at its third iteration is within 1e-6 of its
# eighth, so every final-cost gate against the IMPLICIT run holds, and a
# NaN burst's two rollbacks leave one step to accept.
VENICE_LM = 3
VENICE_FULL_LM = ("implicit", "implicit_guarded")
# LM iterations of phase 5's f64 paths (cut from 8 for the same limit):
# enough for every fault window (the crush's rollback at iteration 3, a
# persistent burst's FATAL after 4) and short of the cost floor.
F64_LM = 4


def solve_option(dtype, path: str = "implicit", tol_relative: bool = False,
                 lm: int = 8):
    """The solve options of a path: an absolute PCG tolerance of 1e-10
    (every solve runs to its iteration cap or stagnation), or with
    `tol_relative` 1e-6 of the RHS energy (floored at 1e-3 on the bf16
    rung); a variant's Jacobian mode, robust loss (scale 1) or forcing
    with warm starts (INEXACT: tol 1e-1 as eta's cap); at f64
    `DEFAULT_PATH` keeps ProblemOption()'s tolerances, refuse ratio and
    stopping thresholds, under `DEFAULT_LM_CAP`.

    Mixed at f64 starts from trust region 1, not 1e3: from 1e3 that
    rung's trajectory comes, within a few accepted steps, to depend on
    the last bits of its inputs (a 1e-15 relative change of the
    observations moves the last trial cost of an 8-camera solve by
    2.7e-7 through the plain versions alone;
    scripts/torch_mixed_f64_sensitivity.py), and no two summation orders
    then agree at `F64_COST_RTOL`.  From region 1 the same change moves
    no trial cost by more than ~1e-14."""
    from megba_tpu_torch import (AlgoOption, ComputeKind, EdgeOrder,
                                 JacobianMode, PrecondKind,
                                 PreconditionerKind, ProblemOption,
                                 RobustKind, RobustOption, SolverOption)

    kind, fused, rung, _ = PATHS[path]
    extra = VARIANTS.get(path, (path, {}))[1]
    region = 1.0 if rung == "mixed" and dtype == np.float64 else 1e3
    mode = JacobianMode[extra.get("jacobian_mode", "ANALYTICAL")]
    if path == DEFAULT_PATH and dtype == np.float64:
        return ProblemOption(
            compute_kind=ComputeKind[kind], jacobian_mode=mode,
            algo_option=AlgoOption(max_iter=DEFAULT_LM_CAP),
            solver_option=SolverOption(max_iter=30))
    solver = dict(tol=1e-6 if tol_relative else 1e-10,
                  tol_relative=tol_relative)
    if extra.get("forcing"):
        solver = dict(tol=1e-1, forcing=True, warm_start=True)
    return ProblemOption(
        dtype=dtype, compute_kind=ComputeKind[kind], jacobian_mode=mode,
        world_size=extra.get("world", 1),
        robust_kind=RobustKind[extra.get("robust_kind", "NONE")],
        robust_delta=1.0, mixed_precision_pcg=rung == "mixed",
        use_schur=extra.get("use_schur", True),
        robust_option=RobustOption(guards=extra.get("guards", False)),
        algo_option=AlgoOption(max_iter=lm, epsilon1=1e-12, epsilon2=1e-15,
                               initial_region=region),
        solver_option=SolverOption(
            max_iter=30, refuse_ratio=1e30, fused_kernels=fused,
            bf16=rung == "bf16",
            precond=PrecondKind[extra.get("precond", "JACOBI")],
            neumann_order=NEUMANN_ORDER,
            smooth_omega=extra.get("smooth_omega", 0.0),
            max_levels=extra.get("max_levels", 3),
            preconditioner=PreconditionerKind[
                extra.get("preconditioner", "HPP")],
            edge_order=EdgeOrder[extra.get("edge_order", "NATURAL")],
            mesh_2d=extra.get("mesh_2d", False),
            cam_blocks=2 if extra.get("mesh_2d") else 0,
            bf16_collectives=extra.get("bf16_collectives", False),
            **solver))


def solve_inputs(scene, path: str, venice: bool = False):
    """The positional arrays of a path's `flat_solve` (the caller's edges
    in a seeded random order on a shuffled path) and its keyword
    arguments (a seeded fault plan, in that same edge order)."""
    from megba_tpu_torch import make_nan_burst, make_point_indefinite_burst

    extra = VARIANTS.get(path, (path, {}))[1]
    arrays = (scene.cameras0, scene.points0, scene.obs, scene.cam_idx,
              scene.pt_idx)
    if extra.get("shuffle"):
        perm = np.random.default_rng(SHUFFLE_SEED).permutation(
            scene.obs.shape[0])
        arrays = arrays[:2] + tuple(a[perm] for a in arrays[2:])
    n_edges, n_points = arrays[2].shape[0], arrays[1].shape[0]
    kw = {}
    if extra.get("fixed"):
        kw["cam_fixed"] = np.arange(arrays[0].shape[0]) < extra["fixed"]
    fault = extra.get("fault")
    if fault == "nan_camera":
        cams = arrays[0].copy()
        cams[2, 4] = np.nan
        return (cams,) + arrays[1:], kw
    if fault is None:
        return arrays, kw
    if fault == "crush":
        busiest = np.argsort(-np.bincount(arrays[4], minlength=n_points),
                             kind="stable")[:CRUSH_POINTS]
        plan = make_point_indefinite_burst(n_points, busiest, *CRUSH_WINDOW,
                                           n_edges=n_edges)
    else:
        edges = (np.random.default_rng(SHUFFLE_SEED).choice(
            n_edges, NAN_EDGES_VENICE, replace=False) if venice
            else NAN_EDGES_F64)
        plan = make_nan_burst(n_edges, edges, 0,
                              1 if fault == "nan_burst" else 10_000)
    return arrays, dict(kw, fault_plan=plan)


def devices_of(path: str):
    """The `device` argument of a path's flat_solve: every shard of a
    multi-device path on the one card."""
    world = VARIANTS.get(path, (path, {}))[1].get("world", 1)
    return DEVICE if world == 1 else [DEVICE] * world


@contextlib.contextmanager
def count_shard_launches():
    """Launches per kernel and shard of the solves run inside (the mesh's
    own tally, parallel/collectives.ShardLaunches): yields a dict, filled
    on exit as {"name": {k: n}} for the kernels that launched."""
    from megba_tpu_torch.parallel.collectives import ShardLaunches

    out = {}
    with ShardLaunches([k for m in kernel_modules()
                        for k in m.KERNELS]) as tally:
        yield out
    out.update({name: dict(sorted(per.items()))
                for name, per in tally.counts.items() if per})


def kernel_resources(build_logs: dict) -> dict:
    """Registers, shared memory and spill bytes of every kernel
    instantiation, from the `--ptxas-options=-v` output of the builds
    (ops/kernels.BUILD_LOGS): the full table, demangled, goes to
    chiprun_out/nvcc_resources.txt; the log gets the instantiations of
    kernel 1 (the largest sums a thread) and of kernel 4's slot tiles
    (`seg_reduce_tiles`, up to 33 KB of static shared memory at F = 16,
    f64), every one that spills, and per
    library the one with the most registers and the one with the most
    shared memory (the widest shapes of csrc/fused_shapes.cuh).  Returns
    {demangled name: (registers, spill stores, spill loads)}."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    found = {}
    for lib, text in build_logs.items():
        cur = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = (lib, m.group(1))
                found.setdefault(cur, [None, None, None, 0])
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and cur:
                found[cur][1:3] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                found[cur][0] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m and cur:
                found[cur][3] = int(m.group(1))
    names = [n for _, n in found]
    filt = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cu++filt"
    demangled = names
    if names and filt.exists():
        demangled = subprocess.run(
            [str(filt)], input="\n".join(names), capture_output=True,
            text=True, check=True, timeout=60).stdout.splitlines()
    out = {}
    lines = []
    widest = {}
    for (lib, _), name, (regs, st, ld, smem) in zip(found, demangled,
                                                    found.values()):
        out[name] = (regs, st, ld)
        line = (f"{lib}: {name}: {regs} registers, {smem} B shared memory, "
                f"spill stores {st} B, spill loads {ld} B")
        lines.append(line)
        for key, v in (("registers", regs or 0), ("shared memory", smem)):
            if v > widest.get((lib, key), (-1, ""))[0]:
                widest[(lib, key)] = (v, line)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "nvcc_resources.txt").write_text("\n".join(lines) + "\n")
    for line in lines:
        if ("JtjRows" in line or "seg_reduce_tiles" in line
                or "spill stores 0 B" not in line):
            log(f"resources {line}")
    for (lib, key), (_, line) in sorted(widest.items()):
        log(f"resources, most {key}: {line}")
    log(f"resources: {len(lines)} kernel instantiations, "
        f"{sum(1 for v in out.values() if v[1])} of them spill; table in "
        "chiprun_out/nvcc_resources.txt")
    return out


def kernel_modules():
    """The port's kernel modules; every kernel wrapper lives in one."""
    from megba_tpu_torch.ops import fused, segtiles

    return segtiles, fused


def untagged(row: str) -> str:
    """A kernel row's name without its path tag ("name(6,6)[f64] pgo":
    the pose-graph rows of phase 10)."""
    return row.split(" ")[0]


def base_name(row: str) -> str:
    """The kernel wrapper of a kernel row ("name", "name[arm]",
    "name(od,d)" or "name(od,d)[arm]", with or without a path tag)."""
    return untagged(row).split("[")[0].split("(")[0]


def kernel_module(name: str):
    name = base_name(name)
    return next(m for m in kernel_modules()
                if name in {k.__name__ for k in m.KERNELS})


def reset_launch_counts() -> None:
    for m in kernel_modules():
        m.reset_launch_counts()


def launch_counts() -> dict:
    out = {}
    for m in kernel_modules():
        out.update(m.launch_counts())
    return out


def arm_launch_counts() -> dict:
    """Launches per kernel and arm, {"name[arm]": count}."""
    out = {}
    for m in kernel_modules():
        out.update(m.arm_launch_counts())
    return out


def kernel_source(name: str) -> str:
    return ("megba_tpu_torch/csrc/"
            f"{kernel_module(name).kernel_source(base_name(name))}.cu")


def cuda_ms(fn, reps: int = 7, batch: int = 10, warmup: int = 2) -> float:
    """Median over `reps` runs of `batch` back-to-back calls of `fn` of the
    CUDA-event time per call, in milliseconds.  Back to back, the host
    enqueues the next call while the card runs this one, so a kernel
    longer than its wrapper's host time is timed without that host time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


@contextlib.contextmanager
def plain_path():
    """Route the solver through the kernels' plain PyTorch versions.

    The consumers call the wrappers through their modules (`segtiles`,
    `fused`), so swapping the module attributes swaps every call site;
    the wrappers themselves never fall back.
    """
    saved = [(m, k.__name__, k) for m in kernel_modules() for k in m.KERNELS]
    try:
        for m, n, _ in saved:
            setattr(m, n, getattr(m, n + "_plain"))
        yield
    finally:
        for m, n, k in saved:
            setattr(m, n, k)


@contextlib.contextmanager
def watch_builds():
    """Record each preconditioner build of the solves run inside: the
    CUDA events around `make_schur_preconditioner` (read them after a
    synchronise) and the cluster plan it was given.  Yields the list of
    (start, end, cluster_plan)."""
    from megba_tpu_torch.solver import pcg

    inner = pcg.make_schur_preconditioner
    builds = []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kw)
        end.record()
        builds.append((start, end, kw.get("cluster_plan")))
        return out

    pcg.make_schur_preconditioner = timed
    try:
        yield builds
    finally:
        pcg.make_schur_preconditioner = inner


def build_ms(builds) -> list:
    return [start.elapsed_time(end) for start, end, _ in builds]


def coarse_words(builds) -> str:
    """The coarse plan of the watched builds: level 1's clusters and pair
    chunks, a multilevel plan's level sizes."""
    plan = builds[0][2]
    base = getattr(plan, "base", plan)
    sizes = getattr(plan, "level_sizes", (base.num_clusters,))
    return (f"C = {base.num_clusters}, levels {tuple(sizes)}, "
            f"{len(base.ec_chunks)} pair chunk(s)")


def bitwise_equal(a, b) -> bool:
    """Equal bits, NaN payloads included (torch.equal fails on NaN)."""
    if a.is_floating_point():
        it = {8: torch.int64, 4: torch.int32, 2: torch.int16}[
            a.element_size()]
        return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _flat(out):
    return torch.cat(out) if isinstance(out, tuple) else out


def _csr_expand(J: torch.Tensor, seg: torch.Tensor, d: int, ns: int):
    """A [od*n, d*nS] with u.flat = A x.flat: the expand as one CSR
    product.  Row o*n+e holds J[o*d+a, e] at column a*nS+seg[e]."""
    od, n = J.shape[0] // d, J.shape[1]
    dev = J.device
    crow = torch.arange(0, od * n + 1, dtype=torch.int64, device=dev) * d
    cols = (torch.arange(d, device=dev)[None, None, :] * ns
            + seg.long()[None, :, None]).expand(od, n, d)
    vals = J.reshape(od, d, n).permute(0, 2, 1)
    return torch.sparse_csr_tensor(crow, cols.reshape(-1), vals.reshape(-1),
                                   (od * n, d * ns), check_invariants=False)


def _csr_reduce(J: torch.Tensor, seg: torch.Tensor, d: int, ns: int):
    """B [d*nS, od*n] with out.flat = B u.flat: the reduce as one CSR
    product.  Entry (b*nS+seg[e], o*n+e) holds J[o*d+b, e]."""
    od, n = J.shape[0] // d, J.shape[1]
    dev = J.device
    b = torch.arange(d, device=dev)[None, :, None]
    o = torch.arange(od, device=dev)[:, None, None]
    e = torch.arange(n, device=dev)[None, None, :]
    rows = (b * ns + seg.long()[None, None, :]).expand(od, d, n)
    cols = (o * n + e).expand(od, d, n)
    coo = torch.sparse_coo_tensor(
        torch.stack([rows.reshape(-1), cols.reshape(-1)]), J.reshape(-1),
        (d * ns, od * n), check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def _csr_coupling(W: torch.Tensor, fplan, d_in: int, w_in_major: bool):
    """The assembled coupling matrix of one direction, Hlp [3*Np, 9*Nc]
    or Hpl [9*Nc, 3*Np], as MegBA's EXPLICIT path stored it: the 9x3
    blocks W_e summed per (camera, point) pair.  Entry (b*nOut+out(e),
    a*nIn+in(e)) holds W_e[a, b] of input dim a and output dim b."""
    d_out = W.shape[0] // d_in
    n_out, n_in = fplan.out.num_segments, fplan.num_in
    dev = W.device
    a = torch.arange(d_in, device=dev)
    b = torch.arange(d_out, device=dev)
    w_rows = (a[:, None] * d_out + b[None, :] if w_in_major
              else b[None, :] * d_in + a[:, None])  # [d_in, d_out]
    out_seg = fplan.out.seg.long()[None, None, :]
    in_idx = fplan.in_idx.long()[None, None, :]
    n = W.shape[1]
    rows = (b[None, :, None] * n_out + out_seg).expand(d_in, d_out, n)
    cols = (a[:, None, None] * n_in + in_idx).expand(d_in, d_out, n)
    vals = W.index_select(0, w_rows.reshape(-1))
    coo = torch.sparse_coo_tensor(
        torch.stack([rows.reshape(-1), cols.reshape(-1)]), vals.reshape(-1),
        (d_out * n_out, d_in * n_in), check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def _spmv(build, *build_args, vec: torch.Tensor, shape):
    """A library yardstick: build the CSR matrix, return its product."""
    mat = build(*build_args)
    return lambda: (mat @ vec.reshape(-1, 1)).reshape(shape)


def _bf16_spmv(build, *build_args, vec: torch.Tensor, shape):
    """The same CSR product with bf16 values and a bf16 vector, or the
    reason PyTorch refuses it on this card."""
    try:
        run = _spmv(build, *build_args, vec=vec.to(torch.bfloat16),
                    shape=shape)
        run()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return str(e).splitlines()[0][:160]
    return run


def _abs(args):
    return tuple(a.abs() if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)


def _case(side, args, nbytes, flops, library=None, kwargs=None,
          library_tol=F32_REL_TO_ABS_SUM, in_total=True, ref64=False):
    """One side of a kernel: its arguments (the same arguments with every
    float operand made |.| give the scale of the f32 check), the bytes
    the kernel must move and the operations it must do, a zero-argument
    function that builds the library yardstick's call (or None; it may
    return a string, the reason there is none), the kernel's keyword
    arguments, the library's tolerance, and whether the side counts in
    the row's totals (the main path's shapes) or only stands beside
    them.  With `ref64` an f32 kernel is held to its plain version
    evaluated in float64 on the same inputs, not to the float32 plain
    version: over a segment of ~1e5 slots two f32 summation orders part
    by more than the f32 rule."""
    return dict(side=side, args=args, abs_args=_abs(args), bytes=nbytes,
                flops=flops, library=library, kwargs=kwargs or {},
                library_tol=library_tol, in_total=in_total, ref64=ref64)


def _f64(args):
    return tuple(a.to(torch.float64) if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)


def _plan_of(args):
    from megba_tpu_torch.ops.segtiles import SegPlan

    for a in args:
        if isinstance(a, SegPlan):
            return a
        if hasattr(a, "out") and isinstance(a.out, SegPlan):
            return a.out
    return None


def row_arm(name: str) -> str:
    """The precision arm of a kernel row: "name[arm]" or f32."""
    name = untagged(name)
    return name.split("[")[1][:-1] if "[" in name else "f32"


def row_shape(name: str):
    """The shape of a kernel row "name(a,b,...)[arm]" ((od, d) for
    kernels 1-3, (F,) for 4-5, (d,) for 6, (d_in, d_out) for 8, (cd, pd,
    od) for 7), or None (the BAL rows, whose sides are the camera and the
    point)."""
    head = untagged(name).split("[")[0]
    if "(" not in head:
        return None
    return tuple(int(v) for v in head[head.index("(") + 1:-1].split(","))


def measure_rows(cases: dict) -> dict:
    """Each kernel row of `cases` ({row name: [_case, ...]}): per side, the
    kernel against its plain version (two launches bitwise equal; f32
    within `F32_REL_TO_ABS_SUM` and f64 within `F64_REL_TO_ABS_SUM` of
    the sums of the terms' magnitudes, and f64 also within
    `F64_REL_TO_ROW_MAX` of the row's largest magnitude), then CUDA-event
    medians of the kernel, the plain version and the library yardstick,
    and the bound; the row totals over its main-path sides."""
    rows = {}
    for name, sides in cases.items():
        module = kernel_module(name)
        kernel = getattr(module, base_name(name))
        plain = getattr(module, base_name(name) + "_plain")
        arm = row_arm(name)
        entry = dict(name=name, route="cuda", source=kernel_source(name),
                     replaces=REPLACES[base_name(name)], arm=arm,
                     shape=row_shape(name),
                     launches=None, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                     bound_ms=0.0, bound_by=None, library_ms=0.0, sides={})
        worst = (0.0, None)
        for c in sides:
            side, args, kw = c["side"], c["args"], c["kwargs"]
            got = _flat(kernel(*args, **kw))
            again = _flat(kernel(*args, **kw))
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name}[{side}]: two launches differ")
            if c["ref64"]:
                ref = _flat(plain(*_f64(args), **kw))
                scale = _flat(plain(*_f64(c["abs_args"]), **kw)).abs()
                err = (got.to(ref.dtype) - ref).abs()
            else:
                ref = _flat(plain(*args, **kw))
                scale = _flat(plain(*c["abs_args"], **kw)).abs()
                err = (got - ref).abs()
            rel = (F64_REL_TO_ABS_SUM if got.dtype == torch.float64
                   else F32_REL_TO_ABS_SUM)
            row_max = ref.abs().amax(dim=-1, keepdim=True)
            if not bool((err <= rel * scale).all()) or (
                    got.dtype == torch.float64
                    and not bool((err <= F64_REL_TO_ROW_MAX * row_max).all())):
                raise AssertionError(
                    f"{name}[{side}]: kernel disagrees with plain version "
                    f"(max |err| {float(err.max()):.3e})")
            lib_ms, lib_note = None, None
            if c["library"] is not None:
                run = c["library"]()
                if isinstance(run, str):
                    lib_note = run
                else:
                    lib_err = (run().to(ref.dtype) - ref).abs()
                    lib_ok = bool((lib_err <= c["library_tol"] * scale).all())
                    if not lib_ok and (c["library_tol"]
                                       < BF16_LIBRARY_REL_TO_ABS_SUM):
                        raise AssertionError(
                            f"{name}[{side}]: library yardstick disagrees "
                            f"(max |err| {float(lib_err.max()):.3e})")
                    if lib_ok:
                        lib_ms = cuda_ms(run)
                    else:  # a bf16 product that rounds beyond bf16 reach
                        lib_note = (f"bf16 library result off by up to "
                                    f"{float(lib_err.max()):.3e}")
                del run
            k_ms = cuda_ms(lambda: kernel(*args, **kw))
            p_ms = cuda_ms(lambda: plain(*args, **kw), reps=5)
            nbytes, flops = c["bytes"], c["flops"]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[got.dtype] * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            e_max = float(err.max())
            plan = _plan_of(args)
            k4 = (check_seg_reduce_shape(f"{name}[{side}]", plan)
                  if base_name(name) == "seg_reduce" else None)
            entry["sides"][side] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, share=bound / k_ms, bytes=nbytes, flops=flops,
                max_abs_err=e_max, in_total=c["in_total"],
                per_thread=None if plan is None else plan.per_thread,
                chunks=(None if plan is None or plan.split is None
                        else plan.split.num_chunks),
                library_note=lib_note, seg_reduce_shape=k4)
            lib = ("-" if lib_ms is None else f"{lib_ms:.4f} ms") + (
                "" if lib_note is None else f" (none: {lib_note})")
            log(f"kernel {name}[{side}]: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"library {lib}, bound {bound:.4f} ms ({by}, "
                f"{nbytes / 1e6:.1f} MB at 3.35 TB/s), {bound / k_ms:.1%} of "
                f"bound, max |err| {e_max:.3e}, bitwise repeat ok")
            if not c["in_total"]:
                continue
            entry["ms"] += k_ms
            entry["plain_ms"] += p_ms
            entry["bound_ms"] += bound
            entry["library_ms"] = (None if lib_ms is None or
                                   entry["library_ms"] is None
                                   else entry["library_ms"] + lib_ms)
            entry["max_abs_err"] = max(entry["max_abs_err"], e_max)
            if bound > worst[0]:
                worst = (bound, by)
        entry["bound_by"] = worst[1]
        if base_name(name) in FUSED_COUPLING:
            log(f"kernel {name} per direction: " + "; ".join(
                f"{side} {d['ms']:.4f} ms, bound {d['bound_ms']:.4f} ms, "
                f"{d['share']:.1%} of bound"
                for side, d in entry["sides"].items()) +
                f"; row total {entry['ms']:.4f} ms, bound "
                f"{entry['bound_ms']:.4f} ms, "
                f"{entry['bound_ms'] / entry['ms']:.1%} of bound")
        rows[name] = entry
    return rows


def kernel_phase(scene) -> dict:
    from megba_tpu_torch.core.fm import coupling_rows
    from megba_tpu_torch.io.synthetic import (heavy_tailed_graph,
                                              long_camera_idx)
    from megba_tpu_torch.linear_system.builder import damp_blocks
    from megba_tpu_torch.ops import fused, segtiles
    from megba_tpu_torch.ops.residuals import (
        bal_residual_jacobian_analytical_fm)
    from megba_tpu_torch.solver.precond import block_inv

    dev = DEVICE
    plan_c, plans = segtiles.make_dual_plans(
        scene.cam_idx, scene.pt_idx, scene.cameras0.shape[0],
        scene.points0.shape[0], dev)
    plans = fused.with_fused_plans(plans)
    perm = plan_c.perm

    def fm(a):
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(dev)

    # The main path's inputs: the analytical Jacobian at the initial
    # parameters, Jc and r in camera-slot order, Jp and r in point-slot;
    # W = Jc^T Jp per edge in camera-slot order and, for the cam -> pt
    # direction, in point-slot order; Jc in point-slot order and Jp in
    # camera-slot order for the fused implicit directions; the damped,
    # inverted Hpp blocks; bf16 copies of the rows for the precision arms,
    # and f64 copies of the vectors for the mixed64 arms.
    r, Jc, Jp_cam = bal_residual_jacobian_analytical_fm(
        fm(scene.cameras0[scene.cam_idx[perm]]),
        fm(scene.points0[scene.pt_idx[perm]]), fm(scene.obs[perm]))
    Jp = plans.to_pt(Jp_cam).contiguous()
    Jc_tp = plans.to_pt(Jc).contiguous()
    W = coupling_rows(Jc, Jp_cam, 2).contiguous()
    W_tp = plans.to_pt(W).contiguous()
    r_pt = plans.to_pt(r).contiguous()
    n = r.shape[1]
    nc, npt = plans.cam.num_segments, plans.pt.num_segments
    h_rows, _ = segtiles.jtj_grad_reduce_plain(Jc, r, plans.cam)
    Hpp = h_rows.reshape(9, 9, nc).permute(2, 0, 1)
    Hpp = torch.where((torch.diagonal(Hpp, dim1=1, dim2=2).sum(1) == 0)[
        :, None, None], torch.eye(9, device=dev), Hpp)
    Minv = block_inv(damp_blocks(Hpp, torch.tensor(1e3, device=dev)))
    Minv = Minv.contiguous()
    Hrows = fused.block_diag_rows(Minv)
    bf = torch.bfloat16
    b_Jc, b_Jp, b_Jc_tp, b_Jp_cam = (t.to(bf) for t in (Jc, Jp, Jc_tp,
                                                        Jp_cam))
    b_W, b_W_tp, b_Hrows = W.to(bf), W_tp.to(bf), Hrows.to(bf)
    # W of the bf16 Jacobian rows in f64: what the mixed64 arm of the
    # implicit kernel applies.
    w64_j = coupling_rows(b_Jc.double(), b_Jp_cam.double(), 2).contiguous()
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32)

    x_cam, x_pt = randn(9, nc), randn(3, npt)
    u_cam, u_pt = randn(2, n), randn(2, n)
    d_cam, d_pt = randn(9, n), randn(3, n)
    f64 = torch.float64
    x64_cam, x64_pt = x_cam.to(f64), x_pt.to(f64)
    u64_cam, u64_pt = u_cam.to(f64), u_pt.to(f64)
    to_pt, to_cam = plans.fused_to_pt, plans.fused_to_cam
    es, bs, ds = 4, 2, 8  # f32, bf16 and f64 bytes
    i32, i64 = 4, 8

    def lengths(plan, F):
        return (plan.seg_ptr[1:] - plan.seg_ptr[:-1]).expand(
            F, plan.num_segments).contiguous()

    len_cam, len_pt = lengths(plans.cam, 9), lengths(plans.pt, 3)

    def coupling_cases(rows_tp, rows, row_bytes, flops_per_slot, kwargs,
                       library, lib_w=None):
        """Both directions of a fused coupling kernel: its rows in point
        order (cam -> pt) and in camera order (pt -> cam), each slot
        reading its rows, its input id and the CSR offsets of the output
        side, the table read once and the output written once.  The
        library yardstick's CSR values (`lib_w`, W in point and camera
        order) and vector are f32, bf16 or (for the mixed64 arm, the
        same function as the kernel: W from the bf16 rows, in f64)
        f64."""
        spmv = _bf16_spmv if library == "bf16" else _spmv
        w_tp, w = lib_w or {"f32": (W_tp, W), "bf16": (b_W_tp, b_W)}[library]
        xc, xp, vs = (x64_cam, x64_pt, ds) if library == "f64" else (
            x_cam, x_pt, es)
        tol = (BF16_LIBRARY_REL_TO_ABS_SUM if library == "bf16"
               else F32_REL_TO_ABS_SUM)
        return [
            _case("cam_to_pt", (*rows_tp, xc, to_pt),
                  row_bytes * n + (9 * nc + 3 * npt) * vs + n * i32
                  + (npt + 1) * i64, n * flops_per_slot,
                  lambda: spmv(_csr_coupling, w_tp, to_pt, 9, True,
                               vec=xc, shape=(3, npt)),
                  kwargs, tol),
            _case("pt_to_cam", (*rows, xp, to_cam),
                  row_bytes * n + (3 * npt + 9 * nc) * vs + n * i32
                  + (nc + 1) * i64, n * flops_per_slot,
                  lambda: spmv(_csr_coupling, w, to_cam, 3, False,
                               vec=xp, shape=(9, nc)),
                  kwargs, tol),
        ]

    def w_cases(w_tp, w, elt, kwargs, library, lib_w=None):
        out = coupling_cases((w_tp,), (w,), 27 * elt, 2 * 27, kwargs,
                             library, lib_w)
        out[0]["args"] += (True,)
        out[1]["args"] += (False,)
        for c in out:
            c["abs_args"] = _abs(c["args"])
        return out

    def block_diag_case(rows, elt, kwargs, library):
        return [_case("cam", (rows, x_cam), 81 * nc * elt + 18 * nc * es,
                      nc * 2 * 81, library, kwargs,
                      F32_REL_TO_ABS_SUM if elt == es
                      else BF16_LIBRARY_REL_TO_ABS_SUM)]

    def expand_cases(jc, jp, je, ve, kwargs, library):
        """coupling_expand on both sides: J rows of `je` bytes, table and
        u of `ve` bytes; the library yardstick is the expand as one CSR
        product with values and vector in `library`'s dtype."""
        spmv = _bf16_spmv if library == "bf16" else _spmv
        lt = {"f32": torch.float32, "bf16": bf, "f64": f64}[library]
        xc, xp = (x64_cam, x64_pt) if ve == ds else (x_cam, x_pt)
        tol = (BF16_LIBRARY_REL_TO_ABS_SUM if library == "bf16"
               else F32_REL_TO_ABS_SUM)
        return [
            _case("cam", (xc, jc, plans.cam, 9),
                  18 * n * je + (9 * nc + 2 * n) * ve + n * i32, n * 2 * 18,
                  lambda: spmv(_csr_expand, jc.to(lt), plans.cam.seg, 9, nc,
                               vec=xc, shape=(2, n)), kwargs, tol),
            _case("pt", (xp, jp, plans.pt, 3),
                  6 * n * je + (3 * npt + 2 * n) * ve + n * i32, n * 2 * 6,
                  lambda: spmv(_csr_expand, jp.to(lt), plans.pt.seg, 3, npt,
                               vec=xp, shape=(2, n)), kwargs, tol),
        ]

    def reduce_cases(jc, jp, je, ve, kwargs, library):
        """coupling_reduce on both sides, as `expand_cases`."""
        spmv = _bf16_spmv if library == "bf16" else _spmv
        lt = {"f32": torch.float32, "bf16": bf, "f64": f64}[library]
        uc, up = (u64_cam, u64_pt) if ve == ds else (u_cam, u_pt)
        tol = (BF16_LIBRARY_REL_TO_ABS_SUM if library == "bf16"
               else F32_REL_TO_ABS_SUM)
        return [
            _case("cam", (jc, uc, plans.cam, 9),
                  18 * n * je + (2 * n + 9 * nc) * ve + (nc + 1) * i64,
                  n * 2 * 18,
                  lambda: spmv(_csr_reduce, jc.to(lt), plans.cam.seg, 9, nc,
                               vec=uc, shape=(9, nc)), kwargs, tol),
            _case("pt", (jp, up, plans.pt, 3),
                  6 * n * je + (2 * n + 3 * npt) * ve + (npt + 1) * i64,
                  n * 2 * 6,
                  lambda: spmv(_csr_reduce, jp.to(lt), plans.pt.seg, 3, npt,
                               vec=up, shape=(3, npt)), kwargs, tol),
        ]

    implicit_bytes = {es: 24 * es, bs: 24 * bs}
    mixed, bf16 = dict(bf16_operands=False), dict(bf16_operands=True)
    cases = {
        "jtj_grad_reduce": [
            _case("cam", (Jc, r, plans.cam),
                  (20 * n + 90 * nc) * es + (nc + 1) * i64,
                  n * (2 * 2 * 81 + 2 * 2 * 9)),
            _case("pt", (Jp, r_pt, plans.pt),
                  (8 * n + 12 * npt) * es + (npt + 1) * i64,
                  n * (2 * 2 * 9 + 2 * 2 * 3)),
        ],
        "coupling_expand": expand_cases(Jc, Jp, es, es, {}, "f32"),
        "coupling_reduce": reduce_cases(Jc, Jp, es, es, {}, "f32"),
        "seg_reduce": [
            _case("cam", (d_cam, plans.cam),
                  (9 * n + 9 * nc) * es + (nc + 1) * i64, 9 * n,
                  lambda: lambda: torch.segment_reduce(
                      d_cam, "sum", lengths=len_cam, axis=1, unsafe=True)),
            _case("pt", (d_pt, plans.pt),
                  (3 * n + 3 * npt) * es + (npt + 1) * i64, 3 * n,
                  lambda: lambda: torch.segment_reduce(
                      d_pt, "sum", lengths=len_pt, axis=1, unsafe=True)),
        ],
        "seg_expand": [
            _case("cam", (x_cam, plans.cam),
                  (9 * nc + 9 * n) * es + n * i32, 0,
                  lambda: lambda: x_cam.index_select(1, plans.cam.seg)),
            _case("pt", (x_pt, plans.pt),
                  (3 * npt + 3 * n) * es + n * i32, 0,
                  lambda: lambda: x_pt.index_select(1, plans.pt.seg)),
        ],
        "fused_coupling_apply": w_cases(W_tp, W, es, {}, "f32"),
        "fused_coupling_apply_implicit": coupling_cases(
            (Jc_tp, Jp), (Jp_cam, Jc), implicit_bytes[es], 2 * 24, {},
            "f32"),
        "fused_block_diag_apply": block_diag_case(
            Hrows, es, {}, lambda: lambda: torch.einsum(
                "nij,jn->in", Minv, x_cam)),
        "fused_coupling_apply_implicit[mixed]": coupling_cases(
            (b_Jc_tp, b_Jp), (b_Jp_cam, b_Jc), implicit_bytes[bs], 2 * 24,
            mixed, "bf16"),
        "fused_coupling_apply_implicit[bf16]": coupling_cases(
            (b_Jc_tp, b_Jp), (b_Jp_cam, b_Jc), implicit_bytes[bs], 2 * 24,
            bf16, "bf16"),
        "fused_coupling_apply[mixed]": w_cases(b_W_tp, b_W, bs, mixed,
                                               "bf16"),
        "fused_coupling_apply[bf16]": w_cases(b_W_tp, b_W, bs, bf16, "bf16"),
        "fused_block_diag_apply[bf16]": block_diag_case(
            b_Hrows, bs, bf16, lambda: lambda: torch.einsum(
                "nij,jn->in", Minv.to(bf), x_cam.to(bf))),
        "coupling_expand[mixed]": expand_cases(b_Jc, b_Jp, bs, es, mixed,
                                               "bf16"),
        "coupling_expand[mixed64]": expand_cases(b_Jc, b_Jp, bs, ds, mixed,
                                                 "f64"),
        "coupling_expand[bf16]": expand_cases(b_Jc, b_Jp, bs, es, bf16,
                                              "bf16"),
        "coupling_reduce[mixed]": reduce_cases(b_Jc, b_Jp, bs, es, mixed,
                                               "bf16"),
        "coupling_reduce[mixed64]": reduce_cases(b_Jc, b_Jp, bs, ds, mixed,
                                                 "f64"),
        "coupling_reduce[bf16]": reduce_cases(b_Jc, b_Jp, bs, es, bf16,
                                              "bf16"),
        "fused_coupling_apply_implicit[mixed64]": coupling_cases(
            (b_Jc_tp, b_Jp), (b_Jp_cam, b_Jc), implicit_bytes[bs], 2 * 24,
            mixed, "f64", (plans.to_pt(w64_j), w64_j)),
        "fused_coupling_apply[mixed64]": w_cases(
            b_W_tp, b_W, bs, mixed, "f64", (b_W_tp.to(f64), b_W.to(f64))),
    }
    # The f64 arm of kernels 1-5, the arm of ProblemOption() (solve_bal's
    # default solve), at 8 bytes a value; the library yardsticks in f64.
    Jc64, Jp64, r64, r64_pt = (t.to(f64) for t in (Jc, Jp, r, r_pt))
    d64_cam, d64_pt = d_cam.to(f64), d_pt.to(f64)
    cases.update({
        "jtj_grad_reduce[f64]": [
            _case("cam", (Jc64, r64, plans.cam),
                  (20 * n + 90 * nc) * ds + (nc + 1) * i64,
                  n * (2 * 2 * 81 + 2 * 2 * 9)),
            _case("pt", (Jp64, r64_pt, plans.pt),
                  (8 * n + 12 * npt) * ds + (npt + 1) * i64,
                  n * (2 * 2 * 9 + 2 * 2 * 3)),
        ],
        "coupling_expand[f64]": expand_cases(Jc64, Jp64, ds, ds, {}, "f64"),
        "coupling_reduce[f64]": reduce_cases(Jc64, Jp64, ds, ds, {}, "f64"),
        "seg_reduce[f64]": [
            _case("cam", (d64_cam, plans.cam),
                  (9 * n + 9 * nc) * ds + (nc + 1) * i64, 9 * n,
                  lambda: lambda: torch.segment_reduce(
                      d64_cam, "sum", lengths=len_cam, axis=1, unsafe=True)),
            _case("pt", (d64_pt, plans.pt),
                  (3 * n + 3 * npt) * ds + (npt + 1) * i64, 3 * n,
                  lambda: lambda: torch.segment_reduce(
                      d64_pt, "sum", lengths=len_pt, axis=1, unsafe=True)),
        ],
        "seg_expand[f64]": [
            _case("cam", (x64_cam, plans.cam),
                  (9 * nc + 9 * n) * ds + n * i32, 0,
                  lambda: lambda: x64_cam.index_select(1, plans.cam.seg)),
            _case("pt", (x64_pt, plans.pt),
                  (3 * npt + 3 * n) * ds + n * i32, 0,
                  lambda: lambda: x64_pt.index_select(1, plans.pt.seg)),
        ],
    })
    # Kernels 7 and 8 at f32 on the heavy-tailed graph: random rows, the
    # bytes and operations counted as for venice.
    hnc, hnp = HEAVY["num_cameras"], HEAVY["num_points"]
    h_cam, h_pt = heavy_tailed_graph(hnc, hnp, seed=0)
    _, hplans = segtiles.make_dual_plans(h_cam, h_pt, hnc, hnp, dev)
    hplans = fused.with_fused_plans(hplans)
    hn = h_cam.shape[0]
    hW, hJc, hJp = 0.1 * randn(27, hn), 0.1 * randn(18, hn), 0.1 * randn(
        6, hn)
    hx_cam, hx_pt = randn(9, hnc), randn(3, hnp)

    s_cam, s_pt = heavy_tailed_graph(HEAVY_SHORT_CAMERAS, hnp, seed=0)
    _, splans = segtiles.make_dual_plans(s_cam, s_pt, HEAVY_SHORT_CAMERAS,
                                         hnp, dev)
    splans = fused.with_fused_plans(splans)
    if s_cam.shape[0] != hn or not splans.cam.per_thread:
        raise AssertionError("the short-camera graph must have the heavy "
                             "graph's slots and short camera segments")

    def heavy_cases(rows_tp, rows, row_bytes, flops_per_slot, tails):
        def nbytes(n_out, tables):
            return (row_bytes * hn + tables * es + hn * i32
                    + (n_out + 1) * i64)

        return [
            _case("cam_to_pt_zipf", (*rows_tp, hx_cam, hplans.fused_to_pt,
                                     *tails[0]),
                  nbytes(hnp, 9 * hnc + 3 * hnp), hn * flops_per_slot,
                  in_total=False),
            _case("pt_to_cam_zipf", (*rows, hx_pt, hplans.fused_to_cam,
                                     *tails[1]),
                  nbytes(hnc, 3 * hnp + 9 * hnc), hn * flops_per_slot,
                  in_total=False),
            _case("pt_to_cam_zipf_short_cams",
                  (*rows, hx_pt, splans.fused_to_cam, *tails[1]),
                  nbytes(HEAVY_SHORT_CAMERAS,
                         3 * hnp + 9 * HEAVY_SHORT_CAMERAS),
                  hn * flops_per_slot, in_total=False),
        ]

    cases["fused_coupling_apply"] += heavy_cases(
        (hplans.to_pt(hW),), (hW,), 27 * es, 2 * 27, ((True,), (False,)))
    # Kernels 1 and 3 on the heavy graph's camera side (split segments),
    # beside 7 and 8's rows: random rows in camera order.
    hr, hu = randn(2, hn), randn(2, hn)
    cases["jtj_grad_reduce"].append(_case(
        "cam_zipf", (hJc, hr, hplans.cam),
        (20 * hn + 90 * hnc) * es + (hnc + 1) * i64,
        hn * (2 * 2 * 81 + 2 * 2 * 9), in_total=False))
    cases["coupling_reduce"].append(_case(
        "cam_zipf", (hJc, hu, hplans.cam, 9),
        18 * hn * es + (2 * hn + 9 * hnc) * es + (hnc + 1) * i64,
        hn * 2 * 18,
        lambda: _spmv(_csr_reduce, hJc, hplans.cam.seg, 9, hnc, vec=hu,
                      shape=(9, hnc)), in_total=False))
    cases["fused_coupling_apply_implicit"] += heavy_cases(
        (hplans.to_pt(hJc), hplans.to_pt(hJp)), (hJp, hJc), 24 * es, 2 * 24,
        ((), ()))
    # Kernels 8 and 7 in their ring-step form at the venice 2 x 2 mesh's
    # shapes: the bucket of device (0, 0) over its own point shard (the
    # first step of its ring), random rows, the point shard as the table
    # and the camera tile as the output.
    tplan = segtiles.build_camera_tile_plan(
        scene.cam_idx, scene.pt_idx, nc, npt, 2, 2, quantum=1)
    tdev = segtiles.device_camera_tile_plan(tplan, [dev] * 4)
    ring = tdev.rings[0][0]
    rn, Sp, Tc = ring.out.n_slots, tplan.shard_points, tplan.tile_cams
    rW, rJin, rJout = (0.1 * randn(rows, rn) for rows in (27, 6, 18))
    r_table = randn(3, Sp)

    def ring_case(rows, row_bytes, flops_per_slot, lib_w, tail):
        return [_case(
            "bucket_0_0", (*rows, r_table, ring, *tail),
            row_bytes * rn + (3 * Sp + 9 * Tc) * es + rn * i32
            + (Tc + 1) * i64, rn * flops_per_slot,
            lambda: _spmv(_csr_coupling, lib_w, ring, 3, False,
                          vec=r_table, shape=(9, Tc)))]

    cases["fused_ring_step_apply"] = ring_case((rW,), 27 * es, 2 * 27, rW,
                                               (False,))
    cases["fused_ring_step_apply_implicit"] = ring_case(
        (rJin, rJout), 24 * es, 2 * 24, coupling_rows(rJout, rJin, 2)
        .contiguous(), ())
    log(f"ring-step bucket (venice 2 x 2, device (0, 0), step 0): {rn} "
        f"slots, {Sp} points a shard, {Tc} cameras a tile, "
        f"{'slot tiles' if ring.out.per_thread else 'a block per camera'}")
    # Kernels 1 and 3 on LONG_CAMERAS long cameras: random rows, held to
    # the plain versions in float64 (`_case`'s `ref64`) as the pose
    # prior's 200,000-slot point is.
    lhost = segtiles.build_seg_plan(long_camera_idx(LONG_CAMERAS),
                                    LONG_CAMERAS)
    lplan = segtiles.device_plan(lhost, np.zeros_like(lhost.perm), dev)
    ln, lnc = lplan.n_slots, LONG_CAMERAS
    lJ, lr, lu = 0.1 * randn(18, ln), randn(2, ln), randn(2, ln)
    cases["jtj_grad_reduce"].append(_case(
        "cam_long", (lJ, lr, lplan),
        (20 * ln + 90 * lnc) * es + (lnc + 1) * i64,
        ln * (2 * 2 * 81 + 2 * 2 * 9), in_total=False, ref64=True))
    cases["coupling_reduce"].append(_case(
        "cam_long", (lJ, lu, lplan, 9),
        (20 * ln + 9 * lnc) * es + (lnc + 1) * i64, ln * 2 * 18,
        lambda: _spmv(_csr_reduce, lJ, lplan.seg, 9, lnc, vec=lu,
                      shape=(9, lnc)),
        library_tol=F32_LONG_LIBRARY_REL_TO_ABS_SUM, in_total=False,
        ref64=True))
    # Kernel 4 at f32 and f64 on the heavy-tailed graph's point side
    # (Zipf tracks: segments of 256 slots and more on a short side, summed
    # by a whole block) and camera side, and on the long cameras
    # (5,000-40,000 slots, split chunks; at f32 held to the f64 plain
    # version).
    for side, plan, d, kw in (("pt_zipf", hplans.pt, 3, {}),
                              ("cam_zipf", hplans.cam, 9, {}),
                              ("cam_long", lplan, 9, dict(
                                  ref64=True, library_tol=(
                                      F32_LONG_LIBRARY_REL_TO_ABS_SUM)))):
        m, ns = plan.n_slots, plan.num_segments
        data = randn(d, m)
        seg_len = lengths(plan, d)
        for row, x, size, arm_kw in (("seg_reduce", data, es, kw),
                                     ("seg_reduce[f64]", data.to(f64), ds,
                                      {})):
            cases[row].append(_case(
                side, (x, plan), (d * m + d * ns) * size + (ns + 1) * i64,
                d * m, lambda x=x, seg_len=seg_len: lambda:
                torch.segment_reduce(x, "sum", lengths=seg_len, axis=1,
                                     unsafe=True), in_total=False, **arm_kw))
    track = hplans.pt.seg_ptr[1:] - hplans.pt.seg_ptr[:-1]
    log(f"heavy-tailed graph: {hnc} cameras, {hnp} points, {hn} slots, "
        f"longest track {int(track.max())}, {int((track == 0).sum())} "
        f"points without one; with {HEAVY_SHORT_CAMERAS} cameras for the "
        "short-camera pt->cam")
    for label, plan in (("venice cam", plans.cam), ("venice pt", plans.pt),
                        ("heavy-tailed cam", hplans.cam),
                        ("heavy-tailed pt", hplans.pt),
                        ("long cam", lplan)):
        log(f"{label} side: {plan.num_segments} segments, {plan.n_slots} "
            f"slots; kernels 1 and 3 {launch_shape(plan)}; "
            f"{seg_reduce_words(plan)}")

    rows = measure_rows(cases)
    # Kernel 6 runs at its launch floor, where a CUDA-event time of back
    # to back launches is the wrapper's host time: both arms and their
    # einsum yardsticks also get torch.profiler's device time per call.
    for name, kernel, library in (
            ("fused_block_diag_apply",
             lambda: fused.fused_block_diag_apply(Hrows, x_cam),
             lambda: torch.einsum("nij,jn->in", Minv, x_cam)),
            ("fused_block_diag_apply[bf16]",
             lambda: fused.fused_block_diag_apply(b_Hrows, x_cam,
                                                  bf16_operands=True),
             functools.partial(torch.einsum, "nij,jn->in", Minv.to(bf),
                               x_cam.to(bf)))):
        entry = rows[name]
        k_ms = entry["device_ms"] = device_ms_per_call(kernel)
        lib_ms = entry["library_device_ms"] = device_ms_per_call(library)
        verdict = "slower" if k_ms > lib_ms else "not slower"
        log(f"kernel {name}: device time {k_ms * 1e3:.3f} us a launch "
            f"(torch.profiler), torch.einsum {lib_ms * 1e3:.3f} us a call "
            f"(its operands made beforehand): the kernel is {verdict} than "
            "its library call on the device")
    return rows


def launch_shape(plan) -> str:
    """Kernels 1 and 3's launch shape on one side's plan, with its
    chunk count where it splits segments."""
    from megba_tpu_torch.ops.segtiles import SPLIT_ABOVE, SPLIT_CHUNK

    if plan.per_thread:
        return "a thread per segment"
    return (f"split segments, {plan.split.num_chunks} chunks (a segment "
            f"over {SPLIT_ABOVE} slots in chunks of at most {SPLIT_CHUNK}; "
            f"at most {plan.split.longest} a segment)")


def seg_reduce_words(plan) -> str:
    """Kernel 4's launch shape on one side's plan: slot tiles (with the
    split chunks of its segments over SPLIT_ABOVE slots), a thread per
    segment or split chunks, and the most slots a block reads and a
    thread adds."""
    from megba_tpu_torch.ops.segtiles import seg_reduce_shape

    k4 = seg_reduce_shape(plan)
    tiles = (f"{k4['tiles']} slot tiles and " if k4["shape"] == "slot tiles"
             else "")
    return (f"kernel 4 {k4['shape']}: {tiles}{k4['chunks']} split chunks, "
            f"at most {k4['block_slots']} slots a block, "
            f"{k4['thread_slots']} a thread")


def check_seg_reduce_shape(what: str, plan) -> dict:
    """Kernel 4's launch on `plan` (`segtiles.seg_reduce_shape`, read off
    the plan's tables), logged and held to `SEG_REDUCE_BOUNDS`: no block
    and no thread owns an unbounded run of slots."""
    from megba_tpu_torch.ops.segtiles import (SEG_REDUCE_BOUNDS,
                                              seg_reduce_shape)

    k4 = seg_reduce_shape(plan)
    bounds = SEG_REDUCE_BOUNDS[k4["shape"]]
    for key, most in bounds.items():
        if k4[key] > most:
            raise AssertionError(f"{what}: kernel 4's {key} {k4[key]} "
                                 f"exceeds its bound {most}")
    log(f"{what}: {seg_reduce_words(plan)} (bounds "
        f"{bounds['block_slots']} and {bounds['thread_slots']})")
    return k4


def row_device_times(rows: dict, cases: dict, names) -> None:
    """torch.profiler's device time per launch of each named row and of
    its library call (`device_ms`, `library_device_ms`), and the
    wrapper's host time a call (`host_ms`), each summed over the row's
    sides as its CUDA-event time is, for rows near the launch floor,
    where a CUDA-event time of back-to-back launches is the wrapper's
    host time."""
    for name in names:
        entry = rows[name]
        k_ms = h_ms = lib_ms = 0.0
        for c in cases[name]:
            kernel = getattr(kernel_module(name), base_name(name))
            k_ms += device_ms_per_call(
                lambda c=c: kernel(*c["args"], **c["kwargs"]))
            h_ms += host_ms_per_call(
                lambda c=c: kernel(*c["args"], **c["kwargs"]))
            run = c["library"]() if c["library"] is not None else None
            lib_ms = (lib_ms + device_ms_per_call(run)
                      if callable(run) and lib_ms is not None else None)
        entry["device_ms"], entry["host_ms"] = k_ms, h_ms
        lib = "no library call"
        if lib_ms is not None:
            entry["library_device_ms"] = lib_ms
            verdict = "slower" if k_ms > lib_ms else "not slower"
            lib = (f"its library call {lib_ms * 1e3:.3f} us: the kernel is "
                   f"{verdict} on the device")
        bound = entry.get("bound_ms")
        share = ("" if not bound else
                 f", {bound / k_ms:.1%} of its bound {bound * 1e3:.3f} us "
                 "by device time")
        sides = "+".join(c["side"] for c in cases[name])
        log(f"kernel {name}[{sides}]: device time {k_ms * 1e3:.3f} us a "
            f"launch (torch.profiler){share}, host time {h_ms * 1e3:.3f} us "
            f"a call (CUDA events {entry['ms'] * 1e3:.3f} us), {lib}")


def host_ms_per_call(fn, calls: int = 200) -> float:
    """The host's time a call of `fn`, in milliseconds: perf_counter over
    `calls` calls that do not wait for the card (fewer launches than its
    queue holds), then a synchronise."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / calls * 1e3


# Profiled windows per device-time reading: a window of 200 small launches
# has come back from torch.profiler with no device event at all on an
# H100, so a reading takes up to this many windows before it fails.
DEVICE_TIME_WINDOWS = 3


def device_ms_per_call(fn, calls: int = 200) -> float:
    """torch.profiler's device time of `calls` calls of `fn`, summed over
    every kernel they launch (the trace's device events,
    `device_time_by_name`), per call, in milliseconds.  A window that
    recorded no device time is profiled again, up to
    `DEVICE_TIME_WINDOWS` windows; then the reading fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(1, DEVICE_TIME_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, _ = device_time_by_name(prof)
        if us > 0:
            return us / calls / 1e3
        log(f"torch.profiler recorded no device time in window {window} of "
            f"{DEVICE_TIME_WINDOWS}")
    raise AssertionError("torch.profiler recorded no device time")


# ---------------------------------------------------------------------------
# Phase 4: the Jacobian engines at full width
# ---------------------------------------------------------------------------


def engine_phase(scene) -> None:
    """The autodiff engines against the closed form at f64 per edge, then
    one linearisation per mode at f32, timed and with its peak memory."""
    from megba_tpu_torch import JacobianMode, make_residual_jacobian_fn
    from megba_tpu_torch.linear_system.builder import weight_system_inputs

    dev = DEVICE
    cam_idx = torch.from_numpy(scene.cam_idx.astype(np.int64)).to(dev)
    pt_idx = torch.from_numpy(scene.pt_idx.astype(np.int64)).to(dev)
    cams = scene.cameras0.astype(np.float64)
    # Cameras under the small-angle threshold (theta^2 < 1e-12): one at
    # zero, seven scaled down; their edges join the f64 comparison.
    cams[0, 0:3] = 0.0
    cams[1:8, 0:3] *= 1e-7
    small = int(np.isin(scene.cam_idx, np.arange(8)).sum())

    def rows(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(dev, dtype)

    modes = ("ANALYTICAL", "AUTODIFF", "AUTODIFF_FORWARD")
    engines = {m: make_residual_jacobian_fn(mode=JacobianMode[m])
               for m in modes}
    f64 = torch.float64
    cam64 = rows(cams, f64).index_select(1, cam_idx)
    pt64 = rows(scene.points0, f64).index_select(1, pt_idx)
    obs64 = rows(scene.obs, f64)
    ref = engines["ANALYTICAL"](cam64, pt64, obs64)
    for m in modes[1:]:
        torch.cuda.reset_peak_memory_stats()
        got = engines[m](cam64, pt64, obs64)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        worst = 0.0
        for name, g, w in zip(("r", "Jc", "Jp"), got, ref):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"engine {m}: non-finite {name}")
            share = float(((g - w).abs().amax(1)
                           / w.abs().amax(1)).max())
            if not share <= ENGINE_REL_TO_ROW_MAX:
                raise AssertionError(
                    f"engine {m}: {name} differs from ANALYTICAL by "
                    f"{share:.3e} of its row's largest magnitude")
            worst = max(worst, share)
        log(f"engine {m} f64: r, Jc, Jp within {worst:.3e} of the row's "
            f"largest magnitude of ANALYTICAL (limit "
            f"{ENGINE_REL_TO_ROW_MAX:g}), {cam64.shape[1]} edges, {small} "
            f"of them on small-angle cameras; peak {peak / 2**30:.3f} GiB")
        del got
    del cam64, pt64, obs64, ref

    f32 = torch.float32
    cams32, pts32 = rows(cams, f32), rows(scene.points0, f32)
    obs32 = rows(scene.obs, f32)
    mask = torch.ones(obs32.shape[1], dtype=f32, device=dev)
    table = []
    for m in modes:
        engine = engines[m]

        def linearise():
            r, Jc, Jp = engine(cams32.index_select(1, cam_idx),
                               pts32.index_select(1, pt_idx), obs32)
            return weight_system_inputs(r, Jc, Jp, cam_idx, pt_idx, mask)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        linearise()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = cuda_ms(linearise, reps=5, batch=2, warmup=1)
        table.append(dict(mode=m, ms=ms, peak_gib=peak / 2**30,
                          above_inputs_gib=(peak - base) / 2**30))
        log(f"engine {m} f32: one linearisation (gathers, engine, "
            f"weighting) {ms:.3f} ms, peak {peak / 2**30:.3f} GiB "
            f"({(peak - base) / 2**30:.3f} GiB above the inputs)")
    for row in table[1:]:
        log(f"engine {row['mode']} f32 against ANALYTICAL: "
            f"{row['ms'] / table[0]['ms']:.2f}x the time, "
            f"{row['above_inputs_gib'] / table[0]['above_inputs_gib']:.2f}x "
            "the memory above the inputs")


# ---------------------------------------------------------------------------
# Phase 5: small f64 end to end, kernels against plain versions
# ---------------------------------------------------------------------------


def cost_gap(ck: np.ndarray, cp: np.ndarray, what: str,
             rolled_back: np.ndarray) -> tuple:
    """The largest relative gap of two trial-cost trajectories over their
    finite entries, on the steps kept and on the rolled-back ones; a NaN
    (or inf) must stand at the same iterations in both.

    A step the guards rolled back under an Hll crush comes from a broken
    PCG on an operator whose crushed blocks scale rounding by ~1/_CRUSH
    (1e8): its trial cost carries the summation order's rounding so
    amplified (PERF.md section 6), and no later value depends on
    it.  It is reported beside the gate, not held to it."""
    bad_k, bad_p = ~np.isfinite(ck), ~np.isfinite(cp)
    if not np.array_equal(bad_k, bad_p):
        raise AssertionError(
            f"{what}: non-finite trial costs at different iterations: "
            f"kernels {np.flatnonzero(bad_k)}, plain {np.flatnonzero(bad_p)}")

    def gap(sel):
        sel = sel & ~bad_k
        if not sel.any():
            return 0.0
        return float(np.max(np.abs(ck[sel] - cp[sel]) / np.abs(cp[sel])))

    return gap(~rolled_back), gap(rolled_back)


ROBUST_TRACE = ("recovery", "pcg_breakdown", "precond_fallback")


def check_path_outcome(what: str, path: str, res, clean_c0: float) -> str:
    """The outcome a path's option fields and fault imply, and its log
    words: a clean path lowers its cost, a NaN burst ends RECOVERED below
    the clean initial cost, a persistent burst FATAL_NONFINITE after
    max_recoveries + 1 iterations, a crush with PCG breakdowns (HPP) or
    counted SCHUR_DIAG fallbacks."""
    from megba_tpu_torch import RobustOption, SolveStatus, status_name

    extra = VARIANTS.get(path, (path, {}))[1]
    fault = extra.get("fault")
    k = res.iterations
    c0, c1 = float(res.initial_cost), float(res.cost)
    tr = res.trace
    flags = "".join("R" if f else "." for f in tr.recovery[:k].tolist())
    status = SolveStatus(res.status)
    if fault in ("persistent", "nan_camera"):
        want = RobustOption().max_recoveries + 1
        if status != SolveStatus.FATAL_NONFINITE or k != want:
            raise AssertionError(f"{what}: {status.name} after {k} LM "
                                 f"iterations, not FATAL_NONFINITE after "
                                 f"{want}")
        words = f"FATAL_NONFINITE after {k} LM iterations, recoveries {flags}"
        if fault == "nan_camera":
            from megba_tpu_torch.solver.precond import (
                decode_precond_fallback_levels)

            levels = [decode_precond_fallback_levels(c)
                      for c in tr.precond_fallback[:k].tolist()]
            if not all(lv and all(lv) for lv in levels):
                raise AssertionError(f"{what}: a poisoned coarse operator "
                                     f"left a level unflagged: {levels}")
            words += f", coarse levels degraded {levels}"
        return words
    if not (np.isfinite(c1) and c1 < clean_c0):
        raise AssertionError(f"{what}: final cost {c1} is not finite and "
                             f"below the clean initial cost {clean_c0}")
    if fault is None:
        if not c1 < c0 or res.recoveries:
            raise AssertionError(f"{what}: cost {c0} -> {c1}, "
                                 f"{res.recoveries} recoveries")
        return f"status {status_name(res.status)}"
    if status != SolveStatus.RECOVERED:
        raise AssertionError(f"{what}: {status.name}, not RECOVERED")
    words = f"RECOVERED ({res.recoveries} recoveries: {flags})"
    if fault == "crush":
        breakdowns = tr.pcg_breakdown[:k].tolist()
        fallback = tr.precond_fallback[:k].tolist()
        if extra.get("preconditioner") == "SCHUR_DIAG":
            if not any(fallback):
                raise AssertionError(f"{what}: no SCHUR_DIAG fallback under "
                                     f"the crush: {fallback}")
        elif not sum(breakdowns):
            raise AssertionError(f"{what}: no PCG breakdown under the crush")
        words += (f", PCG breakdowns {breakdowns}, precond_fallback "
                  f"{fallback}")
    return words


def f64_phase(scene, grid) -> dict:
    """Each path of `F64_PATHS` on the trafalgar-sized f64 scene (the
    coarse paths on its grid twin `grid`), kernels against plain versions;
    the counts are read from each path's kernel run alone.  The trial
    costs agree at `F64_COST_RTOL` where finite and are NaN at the same
    iterations; the accept, recovery, PCG-breakdown and fallback traces,
    the counts, the status and the recoveries are equal.  A coarse path's
    kernel run is repeated and must be bitwise equal (trace, cameras,
    points): its build's sums are deterministic.  Returns each path's
    launches per kernel arm."""
    from megba_tpu_torch import flat_solve

    arm_counts = {}
    kernel_runs = {}
    for path in F64_PATHS:
        kernels = PATHS[path][3]
        coarse = path in COARSE_F64_PATHS or VARIANTS.get(
            path, (path, {}))[1].get("precond") in ("TWO_LEVEL",
                                                     "MULTILEVEL")
        opt = solve_option(np.float64, path, lm=F64_LM)
        arrays, kw = solve_inputs(grid if coarse else scene, path)
        args = arrays + (opt,)
        devs = devices_of(path)
        reset_launch_counts()
        t = time.perf_counter()
        with watch_builds() as builds, count_shard_launches() as shards:
            res_k = flat_solve(None, *args, device=devs, **kw)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t
        counts = launch_counts()
        arm_counts[path] = arm_launch_counts()
        kernel_runs[path] = res_k
        skipped = [k for k in kernels if counts[k] == 0]
        if skipped:
            raise AssertionError(
                f"f64 {path}: the kernel path skipped {skipped}: {counts}")
        want = expected_launches(path, res_k, builds)
        if counts != want:
            raise AssertionError(f"f64 {path}: launches {counts}, the code "
                                 f"implies {want}")
        with plain_path():
            t = time.perf_counter()
            res_p = flat_solve(None, *args, device=devs, **kw)
            torch.cuda.synchronize()
            t_p = time.perf_counter() - t
            if path in PLAIN_REPEAT_PATHS:
                res_p2 = flat_solve(None, *args, device=devs, **kw)
                differ = [f.name for f in dataclasses.fields(res_p.trace)
                          if not bitwise_equal(getattr(res_p.trace, f.name),
                                               getattr(res_p2.trace,
                                                       f.name))]
                if differ or not (
                        bitwise_equal(res_p.cameras, res_p2.cameras)
                        and bitwise_equal(res_p.points, res_p2.points)):
                    raise AssertionError(
                        f"f64 {path}: two plain runs differ (trace fields "
                        f"{differ}, or the solved parameters)")
        k = res_k.iterations

        def tally(res):
            return (res.iterations, res.accepted, res.pcg_iterations,
                    res.status, res.recoveries)

        if tally(res_k) != tally(res_p):
            raise AssertionError(
                f"f64 {path}: counts, status or recoveries differ: kernels "
                f"{tally(res_k)}, plain {tally(res_p)}")
        tk, tp = res_k.trace, res_p.trace
        for f in ("accept", "pcg_iters") + ROBUST_TRACE:
            if not torch.equal(getattr(tk, f)[:k], getattr(tp, f)[:k]):
                raise AssertionError(f"f64 {path}: the {f} traces differ")
        rel, rel_rolled = cost_gap(tk.cost[:k].numpy(), tp.cost[:k].numpy(),
                                   f"f64 {path}", tk.recovery[:k].numpy())
        if not rel <= F64_COST_RTOL:
            raise AssertionError(
                f"f64 {path}: cost trajectories differ (rel {rel:.3e})")
        clean = kernel_runs["implicit_two_level" if coarse else "implicit"]
        outcome = check_path_outcome(f"f64 {path}", path, res_k,
                                     float(clean.initial_cost))
        if path in PLAIN_REPEAT_PATHS:
            outcome += ", two plain runs bitwise equal"
        if path in MESH_BASE:
            one = kernel_runs[MESH_BASE[path]]
            if tally(one) != tally(res_k) or not torch.equal(
                    one.trace.accept[:k], tk.accept[:k]):
                raise AssertionError(
                    f"f64 {path}: counts or accept pattern differ from the "
                    f"world-1 {MESH_BASE[path]} run: {tally(res_k)}, "
                    f"{tally(one)}")
            rel1, _ = cost_gap(tk.cost[:k].numpy(), one.trace.cost[:k].numpy(),
                               f"f64 {path} vs world 1",
                               tk.recovery[:k].numpy())
            if not rel1 <= F64_COST_RTOL:
                raise AssertionError(
                    f"f64 {path}: cost trajectory differs from the world-1 "
                    f"{MESH_BASE[path]} run's (rel {rel1:.3e})")
            outcome += (f", {rel1:.3e} from the world-1 {MESH_BASE[path]} "
                        f"run, counts equal; launches per shard {shards}")
        if coarse:
            res_r = flat_solve(None, *args, device=devs, **kw)
            same = [f.name for f in dataclasses.fields(tk)
                    if not bitwise_equal(getattr(tk, f.name),
                                         getattr(res_r.trace, f.name))]
            if same or not (bitwise_equal(res_k.cameras, res_r.cameras)
                            and bitwise_equal(res_k.points, res_r.points)):
                raise AssertionError(
                    f"f64 {path}: two kernel runs differ (trace fields "
                    f"{same}, or the solved parameters)")
            fallback = tk.precond_fallback[:k].tolist()
            outcome += (f", bitwise equal across two kernel runs; "
                        f"{coarse_words(builds)}, precond_fallback "
                        f"{fallback}")
        if path == "implicit_guarded":
            # Guards on a clean run select the unguarded values bitwise.
            for f in dataclasses.fields(clean.trace):
                if not torch.equal(getattr(clean.trace, f.name),
                                   getattr(tk, f.name)):
                    raise AssertionError(f"f64 {path}: the {f.name} trace "
                                         "differs from the implicit run's")
            if not (torch.equal(clean.cameras, res_k.cameras)
                    and torch.equal(clean.points, res_k.points)):
                raise AssertionError(f"f64 {path}: solved parameters differ "
                                     "from the implicit run's")
            outcome += ", bitwise the implicit run"
        if path == "implicit_coobs":
            natural = flat_solve(None, *arrays, solve_option(
                np.float64, "implicit", lm=F64_LM), device=DEVICE)
            gap = abs(float(res_k.cost) - float(natural.cost)) / float(
                natural.cost)
            outcome += (f", final cost {gap:.3e} relative to NATURAL on the "
                        "same shuffled edges")
        c0, c1 = float(res_k.initial_cost), float(res_k.cost)
        if res_k.recoveries:
            outcome += (f", rolled-back trial costs kernels/plain "
                        f"{rel_rolled:.3e} apart")
        log(f"f64 {path}: {k} LM iterations, {res_k.pcg_iterations} PCG, "
            f"cost {c0:.10e} -> {c1:.10e}, max rel cost gap kernels/plain "
            f"{rel:.3e} (limit {F64_COST_RTOL:g}), accept pattern equal; "
            f"{outcome}; solve {t_k:.2f} s with kernels, {t_p:.2f} s "
            f"plain; launches {arm_counts[path]} (as the code implies)")
    return arm_counts


# ---------------------------------------------------------------------------
# Phase 6: small f32 precision rungs, kernels against plain versions
# ---------------------------------------------------------------------------


def precision_phase(scene) -> None:
    """Each precision-rung path on the trafalgar-sized f32 scene, kernels
    against plain versions: the first LM iteration's trial cost and the
    final cost agree, both finite and below the initial.

    The PCG stops at a relative tolerance here: the kernels and the
    plain versions sum each segment in another order, and on the bf16
    rung a solve driven to stagnation turns that f32 reordering into
    ~1e-3 of the trial cost through its discrete exits (rho or delta
    changing sign), on top of the drift of its nonlinear recurrence
    (`FIRST_COST_RTOL`)."""
    from megba_tpu_torch import flat_solve

    for path, (_, _, rung, kernels) in PATHS.items():
        if rung is None or path in MESH_BASE:
            continue
        args = (scene.cameras0, scene.points0, scene.obs, scene.cam_idx,
                scene.pt_idx, solve_option(np.float32, path,
                                           tol_relative=True))
        reset_launch_counts()
        res_k = flat_solve(None, *args, device=DEVICE)
        torch.cuda.synchronize()
        counts = launch_counts()
        skipped = [k for k in kernels if counts[k] == 0]
        if skipped:
            raise AssertionError(
                f"f32 {path}: the kernel path skipped {skipped}: {counts}")
        with plain_path():
            res_p = flat_solve(None, *args, device=DEVICE)
            torch.cuda.synchronize()
        first_k, first_p = float(res_k.trace.cost[0]), float(
            res_p.trace.cost[0])
        c0 = float(res_k.initial_cost)
        c_k, c_p = float(res_k.cost), float(res_p.cost)
        gap_first = abs(first_k - first_p) / abs(first_p)
        gap = abs(c_k - c_p) / abs(c_p)
        for c in (c_k, c_p):
            if not (np.isfinite(c) and c < c0):
                raise AssertionError(f"f32 {path}: cost did not fall "
                                     f"({c0} -> {c})")
        limits = (f"first trial cost gap {gap_first:.3e} (limit "
                  f"{FIRST_COST_RTOL[rung]:g}), final {gap:.3e} (limit "
                  f"{FINAL_COST_RTOL:g})")
        if not (gap_first <= FIRST_COST_RTOL[rung]
                and gap <= FINAL_COST_RTOL):
            raise AssertionError(f"f32 {path}: kernels vs plain {limits}")
        log(f"f32 {path}: {res_k.iterations} LM iterations, "
            f"{res_k.pcg_iterations} PCG (plain {res_p.pcg_iterations}), "
            f"cost {c0:.8e} -> {c_k:.8e}, kernels vs plain {limits}; "
            f"launches {counts}")


# ---------------------------------------------------------------------------
# Phase 7: the main path at full width
# ---------------------------------------------------------------------------


def expected_launches(path: str, res, builds=(), dims=(9, 3)) -> dict:
    """Launch counts the code implies for one solve.  With k PCG
    iterations an LM iteration runs hpl and hlp k+2 times each under the
    Chronopoulos-Gear body (reduced RHS, k+1 S.p products, back-
    substitution) and k+1 times each under the textbook body of the bf16
    rung (no priming product); the plain full-system solver runs them
    k+1 times each (one of each a product, no reduced RHS and no
    back-substitution).  The preconditioner runs k+1 times, two
    `coupling_expand` for the gain ratio and, on a precision rung, two
    `seg_expand` for the equilibration scales; each linearisation, at an
    accepted step or at a guarded recovery, runs `jtj_grad_reduce`
    twice.  A warm start (every PCG of a warm-started solve, the first
    one's zero x0 included) adds the product of r0 = b - A x0, one hlp
    and one hpl, and one preconditioner apply: it applies M^-1 to r0 and
    to b, where a cold start applies it to b alone.  NEUMANN of order m
    runs m S.p products and m + 1 base applies per preconditioner apply;
    SCHUR_DIAG sums its correction per camera with nine `seg_reduce`
    launches per PCG solve (cd of them at a camera block of cd, `dims`
    = (cd, pd)).  The guards keep one product and one apply
    per PCG iteration, restarts included.  The Jacobian mode, the robust
    loss, the edge order and a fault plan launch nothing.  A TWO_LEVEL or
    MULTILEVEL build (one per PCG solve; `builds` from `watch_builds`)
    sums with `seg_reduce`: ceil(cd pd / 9) launches for the incidence
    rows V (three at BAL's), cd per pair chunk of its plan for the
    contraction and, when smoothed (BAL's blocks only), 12 C for the two
    passes over the C * 9 coarse columns (3 C by point, 9 C by camera,
    whatever the column block); the cycle applies the base once per
    preconditioner apply."""
    kind, fused, rung, _ = PATHS[path]
    extra = VARIANTS.get(path, (path, {}))[1]
    warm = extra.get("forcing", False)
    plain = not extra.get("use_schur", True)
    order = NEUMANN_ORDER if extra.get("precond") == "NEUMANN" else 0
    # On a mesh of N shards each per-edge launch runs once per shard; on
    # the 2-D mesh of C camera columns an S.p product runs one hlp per
    # shard and C ring steps per shard instead of a world hpl and hlp.
    N = extra.get("world", 1)
    C = 2 if extra.get("mesh_2d") else 0
    L, P, A = res.iterations, res.pcg_iterations, res.accepted
    applies = P + (2 * L if warm else L)  # M^-1 applies of the CG
    s_products = P + (0 if rung == "bf16" else L) + (L if warm else 0) \
        + order * applies  # S.p products
    if plain:
        products = 2 * P + 2 * L
    else:
        products = 2 * s_products + 2 * L
    products += 2 * L if warm and plain else 0
    ring = 0
    if C:  # the 2-D mesh: a world hpl + hlp for the RHS and back-sub
        products = 2 * L + s_products
        ring = C * s_products
    want = dict.fromkeys(launch_counts(), 0)
    want["jtj_grad_reduce"] = N * (2 + 2 * (A + res.recoveries))
    want["coupling_expand"] = N * 2 * L
    if not fused and kind == "IMPLICIT":
        want["coupling_expand"] += N * (products + ring)
        want["coupling_reduce"] = N * (products + ring)
    elif not fused:
        want["seg_expand"] = want["seg_reduce"] = N * (products + ring)
    else:
        implicit = kind == "IMPLICIT"
        want["fused_coupling_apply_implicit" if implicit
             else "fused_coupling_apply"] = N * products
        want["fused_ring_step_apply_implicit" if implicit
             else "fused_ring_step_apply"] = N * ring
        want["fused_block_diag_apply"] = (order + 1) * applies
    if rung is not None:
        want["seg_expand"] += N * 2 * L
    cd, pd = dims
    if extra.get("preconditioner") == "SCHUR_DIAG":
        want["seg_reduce"] += N * cd * L
    if extra.get("precond") in ("TWO_LEVEL", "MULTILEVEL"):
        if len(builds) != L:
            raise AssertionError(f"{path}: {len(builds)} preconditioner "
                                 f"builds in {L} LM iterations")
        if extra.get("smooth_omega") and dims != (9, 3):
            raise AssertionError(f"{path}: smoothed launches are counted "
                                 "at BAL's blocks only")
        plan = builds[0][2]
        base = getattr(plan, "base", plan)  # a multilevel plan's level 1
        per_build = N * -(-cd * pd // 9) + cd * len(base.ec_chunks) + (
            12 * N * base.num_clusters if extra.get("smooth_omega") else 0)
        want["seg_reduce"] += per_build * L
    return want


# Kernels 4-8: their launches per shape are checked apart from 1-3's.
SHAPED_4_8 = ("seg_reduce", "seg_expand", "fused_block_diag_apply",
              "fused_coupling_apply", "fused_coupling_apply_implicit",
              "fused_ring_step_apply", "fused_ring_step_apply_implicit")


def expected_shape_launches(path: str, res, builds, spec) -> dict:
    """Launches per shape of kernels 4-8 that one solve of `path` on the
    factor family `spec` implies ({"name(shape)": count}), from the totals
    of `expected_launches`.  Each coupling product runs one direction:
    hlp cam -> pt (kernel 8 at (cd, pd), kernel 7 at (cd, pd, od); an
    unfused EXPLICIT hlp expands cd rows and reduces pd), hpl pt -> cam;
    every LM iteration's products are half hlp, half hpl, but on the 2-D
    mesh, where the RHS runs one world hpl an LM iteration and every
    other product an hlp, beside C ring steps (pt -> cam).  Kernel 6 runs
    at cd; a rung's equilibration expands once at cd and once at pd per
    LM iteration; SCHUR_DIAG reduces cd rows a launch; a coarse build
    reduces V's cd pd rows nine a launch (the last takes the remainder)
    and the contraction cd rows a launch."""
    from collections import Counter

    kind, fused, rung, _ = PATHS[path]
    extra = VARIANTS.get(path, (path, {}))[1]
    cd, pd, od = spec.cam_dim, spec.pt_dim, spec.residual_dim
    want = expected_launches(path, res, builds, (cd, pd))
    N, L = extra.get("world", 1), res.iterations
    out = Counter()

    def add(name, shape, n):
        if n:
            out[f"{name}({','.join(map(str, shape))})"] += n

    if fused:
        implicit = kind == "IMPLICIT"
        name = ("fused_coupling_apply_implicit" if implicit
                else "fused_coupling_apply")
        ring = ("fused_ring_step_apply_implicit" if implicit
                else "fused_ring_step_apply")
        tail = (od,) if implicit else ()
        hpl = N * L if extra.get("mesh_2d") else want[name] // 2
        add(name, (cd, pd) + tail, want[name] - hpl)
        add(name, (pd, cd) + tail, hpl)
        add(ring, (pd, cd) + tail, want[ring])
        add("fused_block_diag_apply", (cd,), want["fused_block_diag_apply"])
    elif kind == "EXPLICIT":
        products = want["seg_reduce"] // 2 if rung is None else None
        if extra.get("preconditioner") or extra.get("precond") or \
                extra.get("mesh_2d") or products is None:
            raise AssertionError(f"{path}: per-shape launches of an unfused "
                                 "EXPLICIT path are counted on its plain "
                                 "form only")
        for d in (cd, pd):
            add("seg_expand", (d,), products)
            add("seg_reduce", (d,), products)
    if rung is not None:
        add("seg_expand", (cd,), N * L)
        add("seg_expand", (pd,), N * L)
    if extra.get("preconditioner") == "SCHUR_DIAG":
        add("seg_reduce", (cd,), N * cd * L)
    if extra.get("precond") in ("TWO_LEVEL", "MULTILEVEL"):
        base = getattr(builds[0][2], "base", builds[0][2])
        for i in range(0, cd * pd, 9):
            add("seg_reduce", (min(9, cd * pd - i),), N * L)
        add("seg_reduce", (cd,), cd * len(base.ec_chunks) * L)
    return dict(out)


def shaped_launch_counts() -> dict:
    """Launches of kernels 4-8 per shape, {"name(shape)": count}."""
    out = {}
    for m in kernel_modules():
        out.update({k: v for k, v in m.shape_launch_counts().items()
                    if base_name(k) in SHAPED_4_8})
    return out


def venice_phase(scene, path: str, profile: bool, ref=None,
                 label: str = "venice", tol_relative: bool = False):
    """One full-width f32 solve of a path (on venice, or on the locality
    scene with `label="locality"`); `ref` is the scene's IMPLICIT run,
    which later paths are compared with; `tol_relative` stops each PCG at
    1e-6 of its right-hand side's energy (`solve_option`).  Returns the
    launch counts, the per-arm counts, the result and the wall time."""
    from megba_tpu_torch import flat_solve

    lm = (VENICE_LM if label == "venice" and path not in VENICE_FULL_LM
          else LOCALITY_LM if label != "venice" else 8)
    opt = solve_option(np.float32, path, tol_relative, lm)
    arrays, kw = solve_inputs(scene, path, venice=True)
    args = arrays + (opt,)
    # A mesh path's one solve runs under the profiler (its busy share);
    # with --profile every path runs once more under it.
    mesh = path in MESH_BASE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with profiled(mesh and not profile) as prof:
        t = time.perf_counter()
        with watch_builds() as builds, count_shard_launches() as shards:
            res = flat_solve(None,
                             *args, verbose=True, device=devices_of(path),
                             **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = launch_counts()
    arms = arm_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    c0, c1 = float(res.initial_cost), float(res.cost)
    skipped = [k for k in PATHS[path][3] if counts[k] == 0]
    if skipped:
        raise AssertionError(
            f"{label} {path}: never launched {skipped}: {counts}")
    want = expected_launches(path, res, builds)
    if counts != want:
        raise AssertionError(f"{label} {path}: launches {counts}, the code "
                             f"implies {want}")
    clean_c0 = c0 if ref is None else float(ref.initial_cost)
    outcome = check_path_outcome(f"{label} {path}", path, res, clean_c0)
    if res.cameras.shape != scene.cameras0.shape or not bool(
            torch.isfinite(res.cameras).all() & torch.isfinite(
                res.points).all()):
        raise AssertionError(f"{label} {path}: solved parameters malformed")
    ref_cost = None if ref is None else float(ref.cost)
    gap = ("" if ref is None else
           f", final cost {abs(c1 - ref_cost) / ref_cost:.3e} relative to "
           "the implicit run's")
    extra = VARIANTS.get(path, (path, {}))[1]
    coarse = extra.get("precond") in ("TWO_LEVEL", "MULTILEVEL")
    limit = (AUTODIFF_COST_RTOL if "jacobian_mode" in extra
             else COOBS_COST_RTOL if "edge_order" in extra
             else LOCALITY_COST_RTOL if coarse and label != "venice"
             else BF16_COST_RTOL if mesh and PATHS[path][2] == "bf16"
             else FINAL_COST_RTOL if mesh
             else None)
    if limit is not None and not abs(c1 - ref_cost) <= limit * ref_cost:
        raise AssertionError(
            f"{label} {path}: final cost {c1} is not within {limit:g} of "
            f"the IMPLICIT run's {ref_cost}")
    if path == "implicit_guarded" and not (
            torch.equal(res.trace.cost, ref.trace.cost)
            and torch.equal(res.cost, ref.cost)
            and (res.iterations, res.accepted, res.pcg_iterations) == (
                ref.iterations, ref.accepted, ref.pcg_iterations)):
        raise AssertionError(f"{label} {path}: not bitwise the implicit run")
    if ref is not None:
        outcome += (f"; PCG {res.pcg_iterations} against the implicit "
                    f"run's {ref.pcg_iterations}")
    if extra.get("preconditioner") == "SCHUR_DIAG":
        fallback = res.trace.precond_fallback[:res.iterations].tolist()
        if any(fallback):
            raise AssertionError(f"{label} {path}: SCHUR_DIAG fell back on a "
                                 f"clean run: {fallback}")
        outcome += f", precond_fallback {fallback}"
    if coarse:
        fallback = res.trace.precond_fallback[:res.iterations].tolist()
        if any(fallback):
            raise AssertionError(f"{label} {path}: the coarse space fell "
                                 f"back on a clean run: {fallback}")
        ms = build_ms(builds)
        outcome += (f"; {coarse_words(builds)}, planned in "
                    f"{res.coarse_plan_seconds:.3f} s on the host, "
                    f"preconditioner build {statistics.median(ms):.3f} ms "
                    f"median of {len(ms)} ({sum(ms):.3f} ms in all), "
                    f"precond_fallback {fallback}")
    log(f"{label} f32 {path}: cost {c0:.8e} -> {c1:.8e}, {res.iterations} LM "
        f"iterations ({res.accepted} accepted), {res.pcg_iterations} PCG "
        f"iterations, flat_solve {wall:.3f} s = {wall / res.iterations:.3f} "
        f"s per LM iteration (planning and transfer included"
        f"{', under the profiler' if mesh and not profile else ''}), peak "
        f"memory {peak / 2**30:.3f} GiB{gap}; {outcome}")
    log(f"{label} {path} launches: {arms} (as the code implies)")
    if mesh:
        log(f"{label} {path} launches per shard: {shards}")
    if label == "venice" and path == "w2_implicit":
        MP_KEPT["venice"] = (res, shards)  # phase 15.1's reference
    if profile:
        profile_solve(args, path, kw, label)
    elif mesh:
        profile_report(prof, wall, path, label)
    return counts, arms, res, wall


def profiled(enabled: bool = True):
    """torch.profiler over the device activity alone when `enabled` (a
    null context otherwise)."""
    from torch.profiler import ProfilerActivity, profile

    return (profile(activities=[ProfilerActivity.CUDA]) if enabled
            else contextlib.nullcontext())


def profile_solve(args, path: str, kw: dict, label: str) -> float:
    """One more solve under torch.profiler: its device time by kernel and
    busy share (`profile_report`), which it returns."""
    from megba_tpu_torch import flat_solve

    torch.cuda.synchronize()
    with profiled() as prof:
        t = time.perf_counter()
        flat_solve(None, *args, device=devices_of(path), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return profile_report(prof, wall, path, label)


def profile_report(prof, wall: float, path: str, label: str) -> float:
    """A profiled solve's device time by kernel (table in chiprun_out/)
    and the device's busy share of its wall time, which it returns.  The
    device activity alone is traced, and its events are summed straight
    from the trace (`device_time_by_name`): `key_averages()` took ~10 s a
    venice-scale solve on an H100, for the same device time."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    dev_us, by_name = device_time_by_name(prof)
    table = "\n".join(
        [f"{'device us':>14}  {'share':>6}  kernel"]
        + [f"{us:14.1f}  {us / max(dev_us, 1e-9):6.1%}  {name[:160]}"
           for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])])
    (out_dir / f"profile_{label}_{path}.txt").write_text(table + "\n")
    log(f"profile {label} {path}: wall {wall:.3f} s under the profiler, "
        f"device busy {dev_us / 1e6:.3f} s ({dev_us / 1e6 / wall:.1%}); "
        f"kernel table in chiprun_out/profile_{label}_{path}.txt")
    log("\n".join(table.splitlines()[:12]))
    return dev_us / 1e6 / wall


def locality_phase(scene, profile: bool) -> None:
    """`LOCALITY_PATHS` on the locality scene, JACOBI first: the coarse
    paths' final costs within `LOCALITY_COST_RTOL` of its, then their PCG
    counts, walls and final costs side by side; with the venice phase's
    options (an absolute PCG tolerance, under which every path runs to
    its PCG cap), then again with a relative one (1e-6 of the RHS energy),
    under which a live coarse space shows in the PCG counts."""
    for tol_relative in (False, True):
        label = "locality_rel" if tol_relative else "locality"
        ref = None
        table = []
        for path in LOCALITY_PATHS:
            _, _, res, wall = venice_phase(scene, path, profile, ref,
                                           label, tol_relative)
            ref = res if ref is None else ref
            table.append(f"{path}: PCG {res.pcg_iterations}, flat_solve "
                         f"{wall:.3f} s, final cost {float(res.cost):.8e}")
        log(f"{label} side by side: " + "; ".join(table))


# ---------------------------------------------------------------------------
# Phase 9: the factor families and the Problem facade
# ---------------------------------------------------------------------------


def make_family_scene(factor: str, cfg: dict, dtype):
    """A family's synthetic scene (seed 0) from its generator."""
    from megba_tpu_torch.factors import priors, radial, rig
    from megba_tpu_torch.models.planar import make_synthetic_planar

    make = {"planar": make_synthetic_planar, "rig": rig.make_synthetic_rig,
            "pinhole_radial": radial.make_synthetic_radial,
            "pose_prior": priors.make_synthetic_priors}[factor]
    t = time.perf_counter()
    s = make(seed=0, dtype=dtype, **cfg)
    log(f"scene {factor}: {s.cameras0.shape[0]} x {s.cameras0.shape[1]} "
        f"cameras, {s.points0.shape[0]} x {s.points0.shape[1]} points, "
        f"{s.obs.shape[0]} edges, {np.dtype(dtype).name}, made in "
        f"{time.perf_counter() - t:.1f} s")
    return s


def shape_cases(od: int, d: int, plan, tag: str) -> dict:
    """Kernel rows of kernels 1-3 at one block shape (od, d) on one side's
    plan of a venice-scale scene, f32 and f64: seeded random J rows,
    residual rows, table and u (the values do not change the work), the
    bytes read once and written once, the library yardstick a cuSPARSE
    CSR product for 2 and 3 (none for 1).  The f32 rows are held to the
    plain versions in float64 (`_case`'s `ref64`): the pose prior's point
    side is one segment of 200,000 slots."""
    n, ns = plan.n_slots, plan.num_segments
    g = torch.Generator(device=DEVICE).manual_seed(od * 100 + d)
    cases = {}
    for dtype, elt, suffix in ((torch.float32, 4, ""),
                               (torch.float64, 8, "[f64]")):
        def randn(*shape, scale=1.0):
            return scale * torch.randn(shape, generator=g, device=DEVICE,
                                       dtype=dtype)

        J, r, u = randn(od * d, n, scale=0.1), randn(od, n), randn(od, n)
        x = randn(d, ns)
        seg, k = plan.seg, f"({od},{d}){suffix}"
        ref64 = dtype == torch.float32
        lib_tol = (F32_LONG_LIBRARY_REL_TO_ABS_SUM if ref64
                   else F32_REL_TO_ABS_SUM)
        cases[f"jtj_grad_reduce{k}"] = [_case(
            tag, (J, r, plan),
            ((od * d + od) * n + (d * d + d) * ns) * elt + (ns + 1) * 8,
            n * (2 * od * d * d + 2 * od * d), ref64=ref64)]
        cases[f"coupling_expand{k}"] = [_case(
            tag, (x, J, plan, d),
            (od * d * n + d * ns + od * n) * elt + n * 4, n * 2 * od * d,
            lambda J=J, x=x: _spmv(_csr_expand, J, seg, d, ns, vec=x,
                                   shape=(od, n)),
            library_tol=lib_tol, ref64=ref64)]
        cases[f"coupling_reduce{k}"] = [_case(
            tag, (J, u, plan, d),
            (od * d * n + od * n + d * ns) * elt + (ns + 1) * 8,
            n * 2 * od * d,
            lambda J=J, u=u: _spmv(_csr_reduce, J, seg, d, ns, vec=u,
                                   shape=(d, ns)),
            library_tol=lib_tol, ref64=ref64)]
    return cases


def family_kernel_cases(factor: str, scene, done: set) -> dict:
    """The rows of `factor`'s camera and point block shapes on its
    venice-scale scene, for each shape not yet in `done` (BAL's shapes
    have rows of their own)."""
    from megba_tpu_torch.factors import get_factor
    from megba_tpu_torch.ops import segtiles

    spec = get_factor(factor)
    _, plans = segtiles.make_dual_plans(
        scene.cam_idx, scene.pt_idx, scene.cameras0.shape[0],
        scene.points0.shape[0], DEVICE)
    cases = {}
    for side, plan, d in (("cam", plans.cam, spec.cam_dim),
                          ("pt", plans.pt, spec.pt_dim)):
        shape = (spec.residual_dim, d)
        log(f"{factor} {side} side {shape}: {plan.num_segments} segments, "
            f"{plan.n_slots} slots; kernels 1 and 3 {launch_shape(plan)}")
        if shape in done:
            continue
        done.add(shape)
        cases.update(shape_cases(*shape, plan, f"{factor}_{side}"))
    return cases


def coupling_shape_cases(cd: int, pd: int, od: int, plans, tag: str,
                         rows: set) -> dict:
    """Kernel rows of kernels 8, 7 and 6 at one family's (cd, pd, od) on
    its venice-scale dual plans (with their fused directions), f32 and
    f64, each row once (`rows`: the row names already made): seeded
    random W, J and M^-1 rows, tables and vectors; both directions of 7
    and 8 (cam -> pt on its launch shape, pt -> cam on its own), the
    bytes each direction must read and write once; the library yardstick
    a cuSPARSE CSR product of the assembled coupling matrix for 7 and 8
    (W = Jc^T Jp per edge for 7), `torch.einsum` for 6.  The f32 rows are
    held to the plain versions in float64 (`_case`'s `ref64`): the pose
    prior's cam -> pt direction is one segment of 200,000 slots."""
    from megba_tpu_torch.core.fm import coupling_rows

    n = plans.cam.n_slots
    nc, npt = plans.cam.num_segments, plans.pt.num_segments
    to_pt, to_cam = plans.fused_to_pt, plans.fused_to_cam
    g = torch.Generator(device=DEVICE).manual_seed(cd * 100 + pd * 10 + od)
    cases = {}
    for dtype, elt, suffix in ((torch.float32, 4, ""),
                               (torch.float64, 8, "[f64]")):
        def randn(*shape, scale=1.0):
            return scale * torch.randn(shape, generator=g, device=DEVICE,
                                       dtype=dtype)

        ref64 = dtype == torch.float32
        lib_tol = (F32_LONG_LIBRARY_REL_TO_ABS_SUM if ref64
                   else F32_REL_TO_ABS_SUM)
        x_cam, x_pt = randn(cd, nc), randn(pd, npt)

        def directions(rows_tp, rows_tc, row_vals, flops_per_slot, w_tp,
                       w_tc, tails):
            """cam -> pt over the point-order rows, pt -> cam over the
            camera-order rows: each slot reads its rows and input id, the
            output side's offsets, the table once, the output written
            once."""
            def nbytes(n_in_vals, n_out_vals, n_out):
                return ((row_vals * n + n_in_vals + n_out_vals) * elt
                        + n * 4 + (n_out + 1) * 8)

            return [
                _case("cam_to_pt", (*rows_tp, x_cam, to_pt, *tails[0]),
                      nbytes(cd * nc, pd * npt, npt), n * flops_per_slot,
                      lambda x=x_cam: _spmv(_csr_coupling, w_tp, to_pt, cd,
                                            True, vec=x, shape=(pd, npt)),
                      library_tol=lib_tol, ref64=ref64),
                _case("pt_to_cam", (*rows_tc, x_pt, to_cam, *tails[1]),
                      nbytes(pd * npt, cd * nc, nc), n * flops_per_slot,
                      lambda x=x_pt: _spmv(_csr_coupling, w_tc, to_cam, pd,
                                           False, vec=x, shape=(cd, nc)),
                      library_tol=lib_tol, ref64=ref64),
            ]

        k8 = f"fused_coupling_apply({cd},{pd}){suffix}"
        if k8 not in rows:
            rows.add(k8)
            W = randn(cd * pd, n, scale=0.1)
            W_tp = plans.to_pt(W).contiguous()
            cases[k8] = directions((W_tp,), (W,), cd * pd, 2 * cd * pd,
                                   W_tp, W, ((True,), (False,)))
        k7 = f"fused_coupling_apply_implicit({cd},{pd},{od}){suffix}"
        if k7 not in rows:
            rows.add(k7)
            Jc, Jp = randn(od * cd, n, scale=0.1), randn(od * pd, n,
                                                         scale=0.1)
            W = coupling_rows(Jc, Jp, od).contiguous()
            cases[k7] = directions(
                (plans.to_pt(Jc).contiguous(), plans.to_pt(Jp).contiguous()),
                (Jp, Jc), od * (cd + pd), 2 * od * (cd + pd),
                plans.to_pt(W).contiguous(), W, ((), ()))
        k6 = f"fused_block_diag_apply({cd}){suffix}"
        if k6 not in rows:
            rows.add(k6)
            Hrows = randn(cd * cd, nc)
            Minv = Hrows.T.reshape(nc, cd, cd)
            cases[k6] = [_case(
                tag, (Hrows, x_cam), (cd * cd + 2 * cd) * nc * elt,
                2 * cd * cd * nc,
                lambda Minv=Minv, x=x_cam: lambda: torch.einsum(
                    "nij,jn->in", Minv, x),
                library_tol=lib_tol, ref64=ref64)]
        for name, (d, plan, side) in {
                f"seg_reduce({cd}){suffix}": (cd, plans.cam, "cam"),
                f"seg_reduce({pd}){suffix}": (pd, plans.pt, "pt"),
                f"seg_expand({cd}){suffix}": (cd, plans.cam, "cam"),
                f"seg_expand({pd}){suffix}": (pd, plans.pt, "pt")}.items():
            if name in rows or d in (9, 3):  # BAL's widths: rows of their own
                continue
            rows.add(name)
            ns = plan.num_segments
            if name.startswith("seg_reduce"):
                data = randn(d, n)
                lengths = (plan.seg_ptr[1:] - plan.seg_ptr[:-1]).expand(
                    d, ns).contiguous()
                cases[name] = [_case(
                    f"{tag}_{side}", (data, plan),
                    (d * n + d * ns) * elt + (ns + 1) * 8, d * n,
                    lambda data=data, lengths=lengths: lambda:
                    torch.segment_reduce(data, "sum", lengths=lengths,
                                         axis=1, unsafe=True),
                    library_tol=lib_tol, ref64=ref64)]
            else:
                table = randn(d, ns)
                cases[name] = [_case(
                    f"{tag}_{side}", (table, plan),
                    (d * ns + d * n) * elt + n * 4, 0,
                    lambda table=table, seg=plan.seg: lambda:
                    table.index_select(1, seg))]
    return cases


def remainder_reduce_case(width: int, plan, tag: str) -> dict:
    """The f64 row of kernel 4 at a coarse build's remainder width (V's
    last nine-row group) on one side's plan: random rows, the bytes read
    once and written once, `torch.segment_reduce` as the yardstick."""
    n, ns = plan.n_slots, plan.num_segments
    g = torch.Generator(device=DEVICE).manual_seed(width)
    data = torch.randn((width, n), generator=g, device=DEVICE,
                       dtype=torch.float64)
    lengths = (plan.seg_ptr[1:] - plan.seg_ptr[:-1]).expand(
        width, ns).contiguous()
    return {f"seg_reduce({width})[f64]": [_case(
        tag, (data, plan), (width * n + width * ns) * 8 + (ns + 1) * 8,
        width * n, lambda: lambda: torch.segment_reduce(
            data, "sum", lengths=lengths, axis=1, unsafe=True))]}


def prior_point_reduce_cases(plan) -> dict:
    """Rows `seg_reduce(3)` / `seg_reduce(3)[f64]`: kernel 4 on the pose
    prior's point side, one segment of 200,000 slots (EXPLICIT's hlp sums
    there), which its split chunks cut into 98 blocks: random rows, the
    bytes read once and written once, `torch.segment_reduce` as the
    yardstick; the f32 row held to the plain version in float64."""
    n, ns = plan.n_slots, plan.num_segments
    g = torch.Generator(device=DEVICE).manual_seed(3)
    lengths = (plan.seg_ptr[1:] - plan.seg_ptr[:-1]).expand(3, ns).contiguous()
    cases = {}
    for dtype, elt, suffix in ((torch.float32, 4, ""),
                               (torch.float64, 8, "[f64]")):
        data = torch.randn((3, n), generator=g, device=DEVICE, dtype=dtype)
        ref64 = dtype == torch.float32
        cases[f"seg_reduce(3){suffix}"] = [_case(
            "pose_prior_pt", (data, plan), (3 * n + 3 * ns) * elt
            + (ns + 1) * 8, 3 * n, lambda data=data: lambda:
            torch.segment_reduce(data, "sum", lengths=lengths, axis=1,
                                 unsafe=True),
            library_tol=(F32_LONG_LIBRARY_REL_TO_ABS_SUM if ref64
                         else F32_REL_TO_ABS_SUM), ref64=ref64)]
    return cases


def check_shape_launches(what: str, counts: dict, shapes: dict,
                         blocks) -> None:
    """Each of kernels 1-3 launched its total (`counts`) half at each of
    the two block shapes `blocks` (camera, point): every linearisation
    and coupling product runs once on each side."""
    for name in ("jtj_grad_reduce", "coupling_expand", "coupling_reduce"):
        want = {f"{name}({od},{d})": counts[name] // 2 for od, d in blocks
                if counts[name]}
        got = {k: v for k, v in shapes.items() if k.startswith(name + "(")}
        if got != want or counts[name] % 2:
            raise AssertionError(f"{what}: {name} launches per shape {got}, "
                                 f"the code implies {want}")


def check_family_launches(what: str, path: str, res, builds, spec) -> dict:
    """A family solve's launches as the code implies: per kernel
    (`expected_launches` at the family's blocks), per shape (kernels 1-3
    half at each side's (od, d), 4-8 by `expected_shape_launches`), and,
    off the precision rungs, every launch in the solve's own arm.
    Returns the launches per shape of kernels 1-8 and per arm."""
    from megba_tpu_torch.ops import segtiles

    cd, pd, od = spec.cam_dim, spec.pt_dim, spec.residual_dim
    counts = launch_counts()
    want = expected_launches(path, res, builds, (cd, pd))
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, the code implies "
                             f"{want}")
    shapes = segtiles.shape_launch_counts()
    check_shape_launches(what, counts, shapes, ((od, cd), (od, pd)))
    got, want45 = shaped_launch_counts(), expected_shape_launches(
        path, res, builds, spec)
    if got != want45:
        raise AssertionError(f"{what}: kernels 4-8 launches per shape "
                             f"{got}, the code implies {want45}")
    arms = arm_launch_counts()
    if PATHS[path][2] is None:
        arm = "f64" if res.cameras.dtype == torch.float64 else "f32"
        one_arm = {f"{k}[{arm}]": v for k, v in counts.items() if v}
        if arms != one_arm:
            raise AssertionError(f"{what}: launches per arm {arms}, the "
                                 f"code implies {one_arm}")
    shapes.update(got)
    return dict(shapes=shapes, arms=arms)


# The factor phase's paths of each family beside its default solve (a
# path of the kernel slices: its kernels and launches, with AUTODIFF):
# at f64 on the trafalgar-sized scene, kernels against plain versions,
# with ProblemOption()'s PCG under `DEFAULT_LM_CAP` (`family_option`);
# at f32 the precision rungs under phase 6's rules, and EXPLICIT unfused
# and fused through the kernels alone (the launches of the f32 rows of
# kernels 4, 5 and 8); at venice scale IMPLICIT with fused kernels.
FAMILY_F64_PATHS = [DEFAULT_PATH, "explicit", "implicit_fused",
                    "explicit_fused", "implicit_schur_diag",
                    "implicit_two_level", "implicit_fused_mixed"]
FAMILY_F32_RUNG_PATHS = ["implicit_fused_mixed", "implicit_fused_bf16"]
# The f32 rung gates start from trust region 1, as every mixed-f64 gate
# does (`solve_option`): from 1e3, reordering the plain versions' own
# sums (the edges in a seeded random order) moves the 8-camera planar
# scene's first trial cost by 3.2e-4 on the mixed rung and 0.10 on bf16,
# and pinhole_radial's bf16 costs by 0.09-0.55, beyond phase 6's limits;
# from 1 by at most 5.6e-7 (first) and 3.7e-5 (final).
FAMILY_F32_REGION = 1.0
FAMILY_F32_LAUNCH_PATHS = ["explicit", "explicit_fused"]
FAMILY_VENICE_PATHS = [DEFAULT_PATH, "implicit_fused"]
# The venice-scale family paths given a profiled re-solve (device busy
# share): the default path only, since phase 12's EXPLICIT and fused
# fleet paths took the fused one's ~60 s of the run's 1200 s.
FAMILY_VENICE_PROFILED = (DEFAULT_PATH,)
# The 2-D mesh's family path: the rig on the 2 x 2 mesh, IMPLICIT fused
# (kernel 7 and its ring-step form at the rig's shapes), held to its
# world-1 path as the f64 phase holds the mesh paths.
FAMILY_MESH = ("rig", "2x2_implicit_fused")


def family_option(dtype, path: str, tol_relative: bool = False,
                  region: float = 0.0):
    """A family path's options: the path's (`solve_option`) with AUTODIFF
    (and the initial trust region `region`, if given); at f64
    ProblemOption()'s PCG tolerance and refuse ratio (the family's own
    default, `factors.registry.resolve_refuse_ratio`) under
    `DEFAULT_LM_CAP`.  Driven to an absolute PCG tolerance of 1e-10, the
    8-camera planar SCHUR_DIAG solve moves its trial costs by up to
    2.7e-10 under a 1e-15 relative change of its observations through the
    plain versions alone (these options: 9e-14)."""
    from megba_tpu_torch import JacobianMode, SolverOption

    opt = dataclasses.replace(solve_option(dtype, path, tol_relative),
                              jacobian_mode=JacobianMode.AUTODIFF)
    if region:
        opt = dataclasses.replace(opt, algo_option=dataclasses.replace(
            opt.algo_option, initial_region=region))
    if dtype != np.float64 or path == DEFAULT_PATH:
        return opt
    default = SolverOption()
    return dataclasses.replace(
        opt, algo_option=dataclasses.replace(opt.algo_option,
                                             max_iter=DEFAULT_LM_CAP),
        solver_option=dataclasses.replace(
            opt.solver_option, tol=default.tol, tol_relative=False,
            refuse_ratio=default.refuse_ratio))


def family_f64_solve(factor: str, scene, path: str, world1=None) -> dict:
    """`flat_solve(factor=)` of one path at f64 (`family_option`) through
    the kernels and through the plain versions, both on the card: trial
    costs within `F64_COST_RTOL`, equal accept pattern, LM / PCG counts
    and status, launches as the code implies per kernel, shape and arm
    (`check_family_launches`); a mesh path also against its world-1 run
    `world1`.  Returns the kernel run and its launches."""
    from megba_tpu_torch import flat_solve
    from megba_tpu_torch.factors import get_factor

    spec = get_factor(factor)
    opt = family_option(np.float64, path)
    args = (scene.cameras0, scene.points0, scene.obs, scene.cam_idx,
            scene.pt_idx, opt)
    devs = devices_of(path)
    reset_launch_counts()
    t = time.perf_counter()
    with watch_builds() as builds, count_shard_launches() as shards:
        kern = flat_solve(None, *args, device=devs, factor=factor)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t
    what = f"f64 {factor} {path}"
    launches = check_family_launches(what, path, kern, builds, spec)
    t = time.perf_counter()
    with plain_path():
        plain = flat_solve(None, *args, device=devs, factor=factor)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t
    k = kern.iterations

    def tally(res):
        return (res.iterations, res.accepted, res.pcg_iterations,
                int(res.status))

    others = [("plain", plain)] + ([("world 1", world1)] if world1 else [])
    gaps = []
    for label, other in others:
        if tally(kern) != tally(other) or not torch.equal(
                kern.trace.accept[:k], other.trace.accept[:k]):
            raise AssertionError(f"{what}: kernels {tally(kern)}, {label} "
                                 f"{tally(other)}, or the accept patterns "
                                 "differ")
        gap, _ = cost_gap(kern.trace.cost[:k].numpy(),
                          other.trace.cost[:k].numpy(), what,
                          np.zeros(k, bool))
        if gap > F64_COST_RTOL:
            raise AssertionError(f"{what}: trial costs {gap:.3e} from the "
                                 f"{label} run's")
        gaps.append(f"{gap:.3e} from {label}")
    c0, c1 = float(kern.initial_cost), float(kern.cost)
    if not c1 < c0:
        raise AssertionError(f"{what}: {k} LM iterations, cost {c0} -> {c1}")
    extra = ""
    if VARIANTS.get(path, (path, {}))[1].get("precond"):
        extra = f"; {coarse_words(builds)}"
    if world1 is not None:
        extra += f"; launches per shard {shards}"
    log(f"{what}: cost {c0:.10e} -> {c1:.10e}, {k} LM iterations "
        f"({kern.accepted} accepted), {kern.pcg_iterations} PCG, status "
        f"{int(kern.status)}; kernels vs {', '.join(gaps)} (gate "
        f"{F64_COST_RTOL:g}), counts and accept pattern equal{extra}; "
        f"solve {t_k:.2f} s with kernels, {t_p:.2f} s plain; launches "
        f"{launches['shapes']} {launches['arms']} (as the code implies)")
    return dict(res=kern, **launches)


def family_f32_solves(factor: str, scene) -> dict:
    """The f32 family paths on the trafalgar-sized scene: each precision
    rung from trust region `FAMILY_F32_REGION`, kernels against plain
    versions under phase 6's rules (first trial cost within
    `FIRST_COST_RTOL`, final within `FINAL_COST_RTOL`, both finite and
    below the initial; the bf16 rung is held to the port's own plain
    solve, not to JAX's: both packages' bf16 CG part from the f32 solve on
    pinhole_radial, ROADMAP Queue 3), its final cost printed beside the
    f32 IMPLICIT fused solve's from the same region; then EXPLICIT unfused
    and fused through the kernels alone.  Launches as the code implies
    per kernel and shape.  Returns each path's launches per shape."""
    from megba_tpu_torch import flat_solve
    from megba_tpu_torch.factors import get_factor

    spec = get_factor(factor)
    arrays = (scene.cameras0, scene.points0, scene.obs, scene.cam_idx,
              scene.pt_idx)
    out = {}
    f32_ref = flat_solve(None, *arrays, family_option(
        np.float32, "implicit_fused", tol_relative=True,
        region=FAMILY_F32_REGION), device=DEVICE, factor=factor)
    for path in FAMILY_F32_RUNG_PATHS + FAMILY_F32_LAUNCH_PATHS:
        rung = PATHS[path][2]
        args = arrays + (family_option(
            np.float32, path, tol_relative=rung is not None,
            region=FAMILY_F32_REGION if rung else 0.0),)
        what = f"f32 {factor} {path}"
        reset_launch_counts()
        res_k = flat_solve(None, *args, device=DEVICE, factor=factor)
        torch.cuda.synchronize()
        out[path] = check_family_launches(what, path, res_k, (), spec)
        c0, c_k = float(res_k.initial_cost), float(res_k.cost)
        if not (np.isfinite(c_k) and c_k < c0):
            raise AssertionError(f"{what}: cost did not fall ({c0} -> {c_k})")
        words = ""
        if rung is not None:
            with plain_path():
                res_p = flat_solve(None, *args, device=DEVICE, factor=factor)
                torch.cuda.synchronize()
            c_p = float(res_p.cost)
            first_k, first_p = (float(res_k.trace.cost[0]),
                                float(res_p.trace.cost[0]))
            gap_first = abs(first_k - first_p) / abs(first_p)
            gap = abs(c_k - c_p) / abs(c_p)
            if not (np.isfinite(c_p) and c_p < c0):
                raise AssertionError(f"{what}: plain cost did not fall")
            words = (f", kernels vs plain: first trial cost gap "
                     f"{gap_first:.3e} (limit {FIRST_COST_RTOL[rung]:g}), "
                     f"final {gap:.3e} (limit {FINAL_COST_RTOL:g}); final "
                     f"cost {c_k / float(f32_ref.cost):.4f}x the f32 "
                     f"IMPLICIT fused solve's")
            if not (gap_first <= FIRST_COST_RTOL[rung]
                    and gap <= FINAL_COST_RTOL):
                raise AssertionError(f"{what}{words}")
        log(f"{what}: {res_k.iterations} LM iterations, "
            f"{res_k.pcg_iterations} PCG, cost {c0:.8e} -> {c_k:.8e}{words}; "
            f"launches {out[path]['shapes']} (as the code implies)")
    return out


def family_venice_solve(factor: str, scene, path: str = DEFAULT_PATH
                        ) -> dict:
    """One venice-scale f32 solve of a family with the venice phase's
    options, AUTODIFF and a path's kernels: wall, LM (accepts) / PCG,
    peak memory (above what the card held before the solve), device busy
    share (the solve run under torch.profiler, on the paths of
    `FAMILY_VENICE_PROFILED`), launches per kernel, shape and arm as the
    code implies, final cost finite and below the initial.  Returns the
    launches per shape."""
    from megba_tpu_torch import flat_solve
    from megba_tpu_torch.factors import get_factor

    spec = get_factor(factor)
    opt = family_option(np.float32, path)
    opt = dataclasses.replace(opt, algo_option=dataclasses.replace(
        opt.algo_option, max_iter=VENICE_LM))
    args = (scene.cameras0, scene.points0, scene.obs, scene.cam_idx,
            scene.pt_idx, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the earlier families' rows
    reset_launch_counts()
    profile = path in FAMILY_VENICE_PROFILED
    with profiled(profile) as prof:
        t = time.perf_counter()
        res = flat_solve(None, *args, device=DEVICE, factor=factor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - held
    what = f"venice f32 {factor} {path}"
    launches = check_family_launches(what, path, res, (), spec)
    c0, c1 = float(res.initial_cost), float(res.cost)
    if not (np.isfinite(c1) and c1 < c0) or res.cameras.shape != \
            scene.cameras0.shape or not bool(torch.isfinite(
                res.cameras).all() & torch.isfinite(res.points).all()):
        raise AssertionError(f"{what}: cost {c0} -> {c1}, or solved "
                             "parameters malformed")
    log(f"{what}: cost {c0:.8e} -> {c1:.8e}, {res.iterations} LM "
        f"iterations ({res.accepted} accepted), {res.pcg_iterations} PCG "
        f"iterations, flat_solve {wall:.3f} s = "
        f"{wall / res.iterations:.3f} s per LM iteration (planning and "
        f"transfer included), peak memory {peak / 2**30:.3f} GiB; "
        f"launches {launches['shapes']} (as the code implies)")
    busy = ""
    if profile:
        busy = ", under the profiler, device busy " + format(profile_report(
            prof, wall, path, f"venice_{factor}"), ".1%")
    log(f"{what} summary: wall {wall:.3f} s, LM {res.iterations} "
        f"({res.accepted}) / PCG {res.pcg_iterations}, peak "
        f"{peak / 2**30:.3f} GiB{busy}")
    return launches["shapes"]


def pose_camera_edge():
    """The facade's custom edge: a pose camera [angle-axis, t], the BAL
    projection with obs = [u, v, f, k1, k2] (focal and distortion as
    edge constants), written as a user of the facade would write it."""
    from megba_tpu_torch import BaseEdge
    from megba_tpu_torch.ops import geo

    class PoseCameraEdge(BaseEdge):
        def forward(self):
            cam, X = self.vertex_estimation(0), self.vertex_estimation(1)
            m = self.get_measurement()
            P = geo.angle_axis_rotate_point(cam[0:3], X) + cam[3:6]
            p = -P[0:2] / P[2]
            n = (p * p).sum(0)
            return m[2] * (1.0 + m[3] * n + m[4] * n * n) * p - m[0:2]

    return PoseCameraEdge


# The libraries `pan_tilt_edge` builds at first use (kernels 1-3 at
# (2, 5); 7 at (5, 3, 2); 6 at 5), by their digest names' stems: the only
# builds after phase 1 (the rebuild sentinel, phase 16).
FIRST_USE_LIBRARIES = ("libfused_5_0_0", "libfused_5_2_3", "libsegtiles_5_2")


def pan_tilt_edge():
    """A user's edge of a shape outside every list: a 5-parameter camera
    [angle-axis, tx, ty] with tz, the focal and the distortion as edge
    constants (obs = [u, v, tz, f, k1, k2]); kernels 1-3 at (2, 5), 7 at
    (5, 3, 2) and 6 at 5 are built at first use."""
    from megba_tpu_torch import BaseEdge
    from megba_tpu_torch.ops import geo

    class PanTiltEdge(BaseEdge):
        def forward(self):
            cam, X = self.vertex_estimation(0), self.vertex_estimation(1)
            m = self.get_measurement()
            t = torch.stack([cam[3], cam[4], m[2]])
            P = geo.angle_axis_rotate_point(cam[0:3], X) + t
            p = -P[0:2] / P[2]
            n = (p * p).sum(0)
            return m[3] * (1.0 + m[4] * n + m[5] * n * n) * p - m[0:2]

    return PanTiltEdge


def facade_phase(scene) -> dict:
    """The Problem facade on the card, on the trafalgar-sized BAL scene
    (f64, ProblemOption() under `DEFAULT_LM_CAP`): the graph built of
    CameraVertex / PointVertex / default edges solves to cameras, points
    and trial costs bitwise equal to `flat_solve` on the same arrays;
    then the custom pose-camera edge (kernels 1-3 at (2, 6)), kernels vs
    plain at f64 under the f64 gates, and once at f32 (the venice
    options; final cost below the initial); the same edge with fused
    IMPLICIT kernels (kernel 7 at (6, 3, 2), 6 at 6), kernels vs plain at
    f64 and once at f32; and the pan-tilt edge (a shape built at first
    use: kernels 1-3 at (2, 5), 7 at (5, 3, 2), 6 at 5) fused IMPLICIT,
    kernels vs plain at f64.  Returns the launches per shape of each
    kernel run, by run."""
    from megba_tpu_torch import (BaseEdge, BaseProblem, CameraVertex,
                                 PointVertex, flat_solve)
    from megba_tpu_torch.ops import segtiles

    opt = solve_option(np.float64, DEFAULT_PATH)

    def build(edge_cls, cameras, obs):
        t = time.perf_counter()
        pb = BaseProblem(opt, device=DEVICE)
        cams = [CameraVertex(c) for c in cameras]
        pts = [PointVertex(p) for p in scene.points0]
        for i, v in enumerate(cams + pts):
            pb.append_vertex(i, v)
        for c, p, m in zip(scene.cam_idx, scene.pt_idx, obs):
            pb.append_edge(edge_cls([cams[c], pts[p]], measurement=m))
        log(f"facade: {len(cams)} cameras, {len(pts)} points and "
            f"{len(obs)} edges appended in {time.perf_counter() - t:.1f} s")
        return pb, cams, pts

    pb, cams, pts = build(BaseEdge, scene.cameras0, scene.obs)
    res = pb.solve()
    direct = flat_solve(None, scene.cameras0, scene.points0, scene.obs,
                        scene.cam_idx, scene.pt_idx, opt, device=DEVICE)
    torch.cuda.synchronize()
    same = (np.array_equal(np.stack([v.estimation for v in cams]),
                           direct.cameras.cpu().numpy())
            and np.array_equal(np.stack([v.estimation for v in pts]),
                               direct.points.cpu().numpy())
            and bitwise_equal(res.trace.cost, direct.trace.cost))
    if not same:
        raise AssertionError("facade: the Problem solve is not bitwise "
                             "flat_solve's on the same arrays")
    log(f"facade BAL: cost {float(res.initial_cost):.10e} -> "
        f"{float(res.cost):.10e}, {res.iterations} LM iterations, cameras, "
        "points and trial costs bitwise equal to flat_solve's")

    def edge_problem(edge_cls, cam_dims, consts):
        obs = np.concatenate([scene.obs, consts[scene.cam_idx]], 1)
        pb, cams, pts = build(edge_cls, scene.cameras0[:, :cam_dims], obs)
        start = [v.estimation.copy() for v in cams + pts]

        def solve(option):
            for v, e in zip(cams + pts, start):
                v.estimation = e.copy()
            pb.option = option
            reset_launch_counts()
            out = pb.solve()
            torch.cuda.synchronize()
            return out

        return solve

    def spec(cd):  # the edge's widths, as a factor spec names them
        return types.SimpleNamespace(cam_dim=cd, pt_dim=3, residual_dim=2)

    def f64_gate(what, solve, path, cd):
        option = family_option(np.float64, path)
        kern = solve(option)
        launches = check_family_launches(what, path, kern, (), spec(cd))
        with plain_path():
            plain = solve(option)
        k = kern.iterations
        gap, _ = cost_gap(kern.trace.cost[:k].numpy(),
                          plain.trace.cost[:k].numpy(), what,
                          np.zeros(k, bool))
        if (k, kern.accepted, kern.pcg_iterations, kern.status) != (
                plain.iterations, plain.accepted, plain.pcg_iterations,
                plain.status) or not torch.equal(
                    kern.trace.accept[:k], plain.trace.accept[:k]) \
                or gap > F64_COST_RTOL or k < 2 or not float(
                    kern.cost) < float(kern.initial_cost):
            raise AssertionError(f"{what}: kernels {k} LM / "
                                 f"{kern.pcg_iterations} PCG, plain "
                                 f"{plain.iterations} / "
                                 f"{plain.pcg_iterations}, trial costs "
                                 f"{gap:.3e} apart")
        log(f"{what}: cost {float(kern.initial_cost):.10e} -> "
            f"{float(kern.cost):.10e}, {k} LM iterations, "
            f"{kern.pcg_iterations} PCG; kernels vs plain {gap:.3e}; "
            f"launches {launches['shapes']} (as the code implies)")
        return launches["shapes"]

    def f32_run(what, solve, path, cd):
        res = solve(family_option(np.float32, path))
        launches = check_family_launches(what, path, res, (), spec(cd))
        if not float(res.cost) < float(res.initial_cost):
            raise AssertionError(f"{what}: cost did not fall")
        log(f"{what}: cost {float(res.initial_cost):.8e} -> "
            f"{float(res.cost):.8e}, {res.iterations} LM iterations; "
            f"launches {launches['shapes']}")
        return launches["shapes"]

    pose = edge_problem(pose_camera_edge(), 6, scene.cameras0[:, 6:9])
    out = {}
    what = "facade pose-camera edge"
    out["f64"] = f64_gate(f"{what} f64", pose, DEFAULT_PATH, 6)
    out["f32"] = f32_run(f"{what} f32", pose, DEFAULT_PATH, 6)
    out["f64 fused"] = f64_gate(f"{what} f64 fused", pose,
                                "implicit_fused", 6)
    out["f32 fused"] = f32_run(f"{what} f32 fused", pose, "implicit_fused",
                               6)
    pan = edge_problem(pan_tilt_edge(), 5, scene.cameras0[:, 5:9])
    t = time.perf_counter()
    out["first use"] = f64_gate("facade pan-tilt edge f64 fused (first "
                                "use)", pan, "implicit_fused", 5)
    log(f"facade pan-tilt edge: {time.perf_counter() - t:.1f} s with the "
        "first-use builds")
    return out


def factor_phase(venice, trafalgar64) -> dict:
    """Phase 9: each registered family beside BAL at its own shapes, and
    the Problem facade.  Returns its kernel rows, each measured right
    after its inputs are made (they are freed before the next family's
    solves) and carrying its launches: every phase-9 run of the row's
    arm at its shape (the f32 row: the venice solves for 1-3, 6 and 7,
    the trafalgar-sized f32 EXPLICIT runs for 4, 5, 6 and 8, the facade's
    f32 runs at (2, 6) and (6, 3, 2); the f64 row: the f64 runs off the
    mixed rung)."""
    from megba_tpu_torch.factors import get_factor
    from megba_tpu_torch.ops import fused, segtiles

    t0 = time.perf_counter()
    done = {(2, 9), (2, 3)}  # BAL's shapes: rows of their own
    made = set()
    f32_launches, f64_launches = {}, {}
    rows = {}

    def credit(table, shapes):
        for row, n in shapes.items():
            table[row] = table.get(row, 0) + n

    for factor in FAMILIES:
        spec = get_factor(factor)
        steps = [time.perf_counter()]
        small = make_family_scene(factor, FAMILY_TRAFALGAR[factor],
                                  np.float64)
        world1 = None
        for path in FAMILY_F64_PATHS:
            run = family_f64_solve(factor, small, path)
            if PATHS[path][2] is None:  # the mixed rung runs mixed64 rows
                credit(f64_launches, run["shapes"])
            if path == MESH_BASE[FAMILY_MESH[1]]:
                world1 = run["res"]
        if factor == FAMILY_MESH[0]:
            credit(f64_launches, family_f64_solve(
                factor, small, FAMILY_MESH[1], world1)["shapes"])
        del small
        steps.append(time.perf_counter())
        small32 = make_family_scene(factor, FAMILY_TRAFALGAR[factor],
                                    np.float32)
        for path, run in family_f32_solves(factor, small32).items():
            if PATHS[path][2] is None:
                credit(f32_launches, run["shapes"])
        del small32
        steps.append(time.perf_counter())
        big = make_family_scene(factor, FAMILY_VENICE[factor], np.float32)
        steps.append(time.perf_counter())
        cases = family_kernel_cases(factor, big, done)
        _, plans = segtiles.make_dual_plans(
            big.cam_idx, big.pt_idx, big.cameras0.shape[0],
            big.points0.shape[0], DEVICE)
        plans = fused.with_fused_plans(plans)
        cases.update(coupling_shape_cases(
            spec.cam_dim, spec.pt_dim, spec.residual_dim, plans, factor,
            made))
        if factor == "planar":  # V's one group of cd pd = 8 rows
            cases.update(remainder_reduce_case(8, plans.pt, "planar_pt"))
        if factor == "pose_prior":  # kernel 4 on the one 200,000-slot point
            cases.update(prior_point_reduce_cases(plans.pt))
        rows.update(measure_rows(cases))
        if factor == "pose_prior":  # the rows near the launch floor
            row_device_times(rows, cases, POSE_PRIOR_DEVICE_ROWS)
        del plans, cases
        torch.cuda.empty_cache()
        steps.append(time.perf_counter())
        for path in FAMILY_VENICE_PATHS:
            credit(f32_launches, family_venice_solve(factor, big, path))
        del big
        torch.cuda.empty_cache()
        steps.append(time.perf_counter())
        log(f"factor phase: {factor} done at {steps[-1] - t0:.1f} s (f64 "
            "paths, f32 paths, venice scene, kernel rows, venice "
            "solves: " + ", ".join(f"{b - a:.1f}"
                                   for a, b in zip(steps, steps[1:]))
            + " s)")
    _, plans = segtiles.make_dual_plans(
        venice.cam_idx, venice.pt_idx, venice.cameras0.shape[0],
        venice.points0.shape[0], DEVICE)
    plans = fused.with_fused_plans(plans)
    cases = shape_cases(*POSE_CAMERA_BLOCK, plans.cam, "venice_pose_camera")
    cases.update(coupling_shape_cases(POSE_CAMERA_BLOCK[1], 3,
                                      POSE_CAMERA_BLOCK[0], plans,
                                      "venice_pose_camera", made))
    rows.update(measure_rows(cases))
    del plans, cases
    torch.cuda.empty_cache()
    facade = facade_phase(trafalgar64)
    # The facade's rows: (2, 6) of kernels 1-3 from its unfused runs,
    # (6, 3, 2) of kernel 7 from its fused ones.
    for run, tag in (("f64", "(2,6)"), ("f32", "(2,6)"),
                     ("f64 fused", "(6,3,2)"), ("f32 fused", "(6,3,2)")):
        table = f64_launches if run.startswith("f64") else f32_launches
        credit(table, {row: n for row, n in facade[run].items()
                       if row.endswith(tag)})
    log(f"factor phase: facade done at {time.perf_counter() - t0:.1f} s")
    for name, row in rows.items():
        if name.endswith("[f64]"):
            row["launches"] = f64_launches.get(name[:-len("[f64]")])
        else:
            row["launches"] = f32_launches.get(name)
    log(f"factor phase: {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 10: pose graphs
# ---------------------------------------------------------------------------

# The pose-graph driver's full size: the JAX package's scale record
# (PGO_SCALE.json, scripts/pgo_scale_cpu.py: 50,000 poses, 15,000 loop
# closures, odometry drift 0.005), here with measurement noise 0.01, under
# solve_pgo's defaults (ProblemOption()) with PGO_FULL_LM LM iterations.
PGO_FULL = dict(num_poses=50_000, loop_closures=15_000, meas_noise=0.01,
                drift_noise=0.005)
PGO_FULL_LM = 30
# The f64 kernels-vs-plain graph: 4,096 poses at the generator's drift,
# ProblemOption() under PGO_SMALL_LM LM iterations, which stop before the
# cost floor (past it an accept turns on rounding).
PGO_SMALL = dict(num_poses=4096, loop_closures=1200, meas_noise=0.01)
PGO_SMALL_LM = 4
PGO_FACTORS = {"se3": "se3_between", "sim3": "sim3_between"}
# The f64 paths: (family, robust kind, priors on three poses, world size).
# The world-2 path is also held to its world-1 path (PGO_MESH_BASE).
PGO_PATHS = {
    "se3": ("se3", None, False, 1),
    "sim3": ("sim3", None, False, 1),
    "se3_huber": ("se3", "HUBER", False, 1),
    "se3_priors": ("se3", None, True, 1),
    "se3_w2": ("se3", None, False, 2),
}
PGO_MESH_BASE = {"se3_w2": "se3"}
PGO_KERNELS = ("jtj_grad_reduce", "coupling_expand", "coupling_reduce",
               "fused_block_diag_apply")
# The full-size solve phase 11 chunks: (family, arm).
PGO_KEEP = ("se3", "f64")


def pgo_graph(family: str, cfg: dict):
    """A synthetic loop-closure graph of a family (seed 0)."""
    from megba_tpu_torch.factors.sim3 import make_synthetic_sim3_graph
    from megba_tpu_torch.models.pgo import make_synthetic_pose_graph

    make = (make_synthetic_sim3_graph if family == "sim3"
            else make_synthetic_pose_graph)
    t = time.perf_counter()
    g = make(seed=0, **cfg)
    log(f"pose graph {family}: {g.poses0.shape[0]} poses, "
        f"{g.edge_i.shape[0]} edges, made in {time.perf_counter() - t:.1f} s")
    return g


def pgo_expected_launches(res, world: int, d: int) -> dict:
    """The launches of a solve_pgo run as the code implies, per kernel
    and shape: per shard, kernel 1 twice per linearisation (the initial
    one and one per accept), kernels 2 and 3 twice per matvec (one PCG
    solve per LM iteration: its PCG iterations and one priming matvec),
    kernel 2 twice more per gain ratio; kernel 6 once per matvec, on the
    first device.  No warm starts on these paths."""
    mv = res.pcg_iterations + res.iterations
    out = {f"jtj_grad_reduce({d},{d})": 2 * world * (1 + res.accepted),
           f"coupling_expand({d},{d})": 2 * world * (mv + res.iterations),
           f"coupling_reduce({d},{d})": 2 * world * mv,
           f"fused_block_diag_apply({d})": mv}
    return {k: v for k, v in out.items() if v}


def pgo_launches(what: str, res, world: int, d: int) -> dict:
    """The run's launches per kernel shape, checked against the code's
    count; no other kernel may have launched."""
    from megba_tpu_torch.ops import fused, segtiles

    counts = {k: v for k, v in launch_counts().items() if v}
    shapes = {k: v for k, v in {**segtiles.shape_launch_counts(),
                                **fused.shape_launch_counts()}.items() if v}
    want = pgo_expected_launches(res, world, d)
    if shapes != want or set(counts) != set(PGO_KERNELS):
        raise AssertionError(f"{what}: launches {shapes}, the code implies "
                             f"{want}")
    return shapes


@contextlib.contextmanager
def record_trial_costs():
    """Collect each LM iteration's trial cost of the solve_pgo runs
    inside (summed over the shards in shard order, as the loop sums
    them): a list the context yields."""
    from megba_tpu_torch.models import pgo

    inner = pgo._trial_cost
    parts = []

    def recorded(sh, *args):
        out = inner(sh, *args)
        parts.append(out)
        return out

    pgo._trial_cost = recorded
    try:
        yield parts
    finally:
        pgo._trial_cost = inner


def pgo_path_inputs(path: str, graphs: dict):
    """(arrays, keywords, option, world) of an f64 path on the small
    graph of its family."""
    from megba_tpu_torch import AlgoOption, ProblemOption, RobustKind
    from megba_tpu_torch.models.pgo import with_priors

    family, robust, priors, world = PGO_PATHS[path]
    g = graphs[family]
    args, kw = [g.poses0, g.edge_i, g.edge_j, g.meas], {}
    if priors:
        n = g.poses0.shape[0]
        idx = np.array([7, n // 3, (2 * n) // 3])
        out = with_priors(*args, prior_idx=idx, prior_poses=g.poses_gt[idx],
                          prior_sqrt_info=np.broadcast_to(
                              np.eye(6) * 10.0, (3, 6, 6)))
        args, kw = list(out[:4]), dict(fixed=out[4], sqrt_info=out[5])
    opt = ProblemOption(world_size=world,
                        algo_option=AlgoOption(max_iter=PGO_SMALL_LM))
    if robust is not None:
        opt = dataclasses.replace(opt, robust_kind=RobustKind[robust],
                                  robust_delta=0.1)
    return args, dict(kw, factor=PGO_FACTORS[family]), opt, world


def pgo_run(args, kw, opt, world: int):
    """One solve_pgo run on the card with its trial costs (every shard
    on the one card)."""
    from megba_tpu_torch.models.pgo import solve_pgo

    device = [DEVICE] * world if world > 1 else DEVICE
    reset_launch_counts()
    with record_trial_costs() as parts:
        res = solve_pgo(*args, opt, device=device, **kw)
    torch.cuda.synchronize()
    trial = torch.stack([sum(parts[k * world:(k + 1) * world][1:],
                             parts[k * world].to(DEVICE))
                         for k in range(res.iterations)]).cpu().numpy()
    return res, trial


def pgo_gate(what: str, kern, kt, ref, rt) -> float:
    """Two runs agree: trial costs at rtol 1e-9, equal LM, accept and PCG
    counts and status, poses within 1e-9 of their magnitude.  Returns the
    trial costs' largest relative gap."""
    gap = float(np.max(np.abs(kt - rt) / np.abs(rt))) if len(rt) else 0.0
    err = float((kern.poses - ref.poses).abs().max())
    if (kern.iterations, kern.accepted, kern.pcg_iterations, kern.status) \
            != (ref.iterations, ref.accepted, ref.pcg_iterations,
                ref.status) or not gap <= F64_COST_RTOL \
            or not err <= 1e-9 * float(ref.poses.abs().max()):
        raise AssertionError(
            f"{what}: {kern.iterations} LM / {kern.accepted} accepted / "
            f"{kern.pcg_iterations} PCG against {ref.iterations} / "
            f"{ref.accepted} / {ref.pcg_iterations}, trial costs {gap:.3e} "
            f"apart, poses {err:.3e} apart")
    return gap


def pgo_f64_paths(graphs: dict) -> dict:
    """Each f64 path through the kernels and through the plain versions
    on the small graph, under `pgo_gate`, with launches as the code
    implies; the world-2 path also against its world-1 path.  Returns the
    kernel runs' launches per shape, summed."""
    launches, kernel_runs = {}, {}
    for path in PGO_PATHS:
        args, kw, opt, world = pgo_path_inputs(path, graphs)
        d = 7 if kw["factor"] == "sim3_between" else 6
        kern, kt = pgo_run(args, kw, opt, world)
        shapes = pgo_launches(f"pgo f64 {path}", kern, world, d)
        with plain_path():
            plain, pt = pgo_run(args, kw, opt, world)
        gap = pgo_gate(f"pgo f64 {path} kernels vs plain", kern, kt, plain,
                       pt)
        extra = ""
        if path in PGO_MESH_BASE:
            base, bt = kernel_runs[PGO_MESH_BASE[path]]
            w1 = pgo_gate(f"pgo f64 {path} vs world 1", kern, kt, base, bt)
            extra = f"; against world 1 {w1:.3e}"
        if kern.accepted < 1 or not float(kern.cost) < float(
                kern.initial_cost):
            raise AssertionError(f"pgo f64 {path}: the cost did not fall")
        kernel_runs[path] = (kern, kt)
        if path == "se3_w2":  # phase 15.2's reference
            MP_KEPT.update(pgo=kern, pgo_graph=graphs["se3"])
        for k, v in shapes.items():
            launches[k] = launches.get(k, 0) + v
        log(f"pgo f64 {path}: cost {float(kern.initial_cost):.10e} -> "
            f"{float(kern.cost):.10e}, {kern.iterations} LM iterations "
            f"({kern.accepted} accepted), {kern.pcg_iterations} PCG, status "
            f"{kern.status}; trial costs kernels vs plain {gap:.3e}{extra}; "
            f"launches {shapes} (as the code implies)")
    return launches


def pgo_g2o_round_trip(g) -> dict:
    """A g2o file with EDGE_SE3_PRIOR records written from the small SE(3)
    graph, read and solved by solve_g2o on the card: bitwise
    with_priors + solve_pgo on the arrays read back.  Returns the
    solve_g2o run's launches per shape."""
    import tempfile

    from megba_tpu_torch import AlgoOption, ProblemOption
    from megba_tpu_torch.core.linalg import psd_sqrt
    from megba_tpu_torch.io.g2o import (G2OGraph, read_g2o, solve_g2o,
                                        sqrt_info_of, write_g2o)
    from megba_tpu_torch.models.pgo import solve_pgo, with_priors

    n = g.poses0.shape[0]
    idx = np.array([11, n // 2], np.int32)
    graph = G2OGraph(
        poses=g.poses0, edge_i=g.edge_i, edge_j=g.edge_j, meas=g.meas,
        info=np.tile(np.diag([4.0, 4.0, 4.0, 1.0, 1.0, 1.0]),
                     (g.edge_i.shape[0], 1, 1)),
        fixed=np.eye(1, n, 0, dtype=bool)[0], ids=np.arange(n) * 2 + 5,
        had_fix=False, prior_idx=idx, prior_meas=g.poses_gt[idx],
        prior_info=np.tile(np.eye(6) * 100.0, (2, 1, 1)))
    opt = ProblemOption(algo_option=AlgoOption(max_iter=PGO_SMALL_LM))
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "graph.g2o")
        write_g2o(path, graph)
        reset_launch_counts()
        back, res = solve_g2o(path, opt, device=DEVICE)
        torch.cuda.synchronize()
        shapes = pgo_launches("pgo g2o", res, 1, 6)
        back2 = read_g2o(path)
    arrays = with_priors(back2.poses, back2.edge_i, back2.edge_j, back2.meas,
                         prior_idx=back2.prior_idx,
                         prior_poses=back2.prior_meas,
                         prior_sqrt_info=psd_sqrt(back2.prior_info),
                         fixed=np.zeros(n, bool),
                         sqrt_info=sqrt_info_of(back2))
    ref = solve_pgo(*arrays[:4], opt, sqrt_info=arrays[5], fixed=arrays[4],
                    device=DEVICE)
    if not (bitwise_equal(res.cost, ref.cost)
            and bitwise_equal(res.poses, ref.poses[:n].contiguous())
            and back.prior_idx.tolist() == idx.tolist()
            and res.accepted >= 1):
        raise AssertionError("pgo g2o: solve_g2o is not bitwise solve_pgo "
                             "on the arrays read back")
    log(f"pgo g2o round trip: {n} poses, {back.edge_i.shape[0]} edges, "
        f"{back.prior_idx.shape[0]} EDGE_SE3_PRIOR records; cost "
        f"{float(res.initial_cost):.10e} -> {float(res.cost):.10e}, "
        f"{res.iterations} LM iterations, bitwise solve_pgo's")
    return shapes


def pgo_full_solve(family: str, g, dtype, keep=None) -> dict:
    """One full-size solve: wall, LM / accept / PCG counts, peak memory,
    launches as the code implies, the maximum translation drift from the
    ground truth before and after (gated: a finite final cost below the
    initial, a smaller drift) and the device's busy share, the solve run
    under torch.profiler.  With `keep` (a dict, which receives the result
    and the wall: phase 11's straight solve) the solve runs without the
    profiler, and once more under it for the busy share.  Returns the
    launches per shape."""
    from megba_tpu_torch import AlgoOption, ProblemOption
    from megba_tpu_torch.models.pgo import solve_pgo

    what = f"pgo full {family} {np.dtype(dtype).name}"
    d = g.poses0.shape[1]
    opt = ProblemOption(dtype=dtype,
                        algo_option=AlgoOption(max_iter=PGO_FULL_LM))
    args = (g.poses0, g.edge_i, g.edge_j, g.meas, opt)
    kw = dict(factor=PGO_FACTORS[family], device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with profiled(keep is None) as prof:
        t = time.perf_counter()
        res = solve_pgo(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    shapes = pgo_launches(what, res, 1, d)
    pwall, where = wall, " under torch.profiler"
    if keep is not None:
        keep.update(res=res, wall=wall)

    def drift(poses):
        return float(np.max(np.linalg.norm(
            np.asarray(poses, np.float64)[:, 3:6] - g.poses_gt[:, 3:6],
            axis=1)))

    d0, d1 = drift(g.poses0), drift(res.poses.cpu().numpy())
    c0, c1 = float(res.initial_cost), float(res.cost)
    if not (np.isfinite(c1) and c1 < c0 and d1 < d0):
        raise AssertionError(f"{what}: cost {c0} -> {c1}, drift {d0} -> "
                             f"{d1}")
    if keep is not None:
        with profiled() as prof:
            t = time.perf_counter()
            solve_pgo(*args, **kw)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t
        where = f" ({pwall:.3f} s under torch.profiler, a second run)"
    dev_us, by_name = device_time_by_name(prof)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:6]
    log(f"{what}: cost {c0:.8e} -> {c1:.8e}, {res.iterations} LM iterations "
        f"({res.accepted} accepted), {res.pcg_iterations} PCG, status "
        f"{res.status}, solve_pgo {wall:.3f} s{where} = "
        f"{wall / max(res.iterations, 1) * 1e3:.1f} ms per LM iteration "
        f"(planning and transfer included), peak memory "
        f"{peak / 2**30:.3f} GiB; max translation drift {d0:.6f} -> "
        f"{d1:.6f}; device busy "
        f"{dev_us / 1e6:.3f} s ({dev_us / 1e6 / pwall:.1%}); launches "
        f"{shapes} (as the code implies); top device time: " + ", ".join(
            f"{name[:48]} {us / 1e3:.1f} ms" for name, us in top))
    return shapes


def device_time_by_name(prof):
    """(device microseconds, {kernel name: microseconds}) of a finished
    torch.profiler run, summed over its device events straight from the
    trace: `key_averages()` builds the event tree first, which took tens
    of seconds on the H100 host for a full-size pose-graph solve's ~10^5
    small launches."""
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if getattr(e.device_type(), "name", "") == "CUDA":
            by_name[e.name()] = by_name.get(e.name(), 0.0) + \
                e.duration_ns() / 1e3
    return sum(by_name.values()), by_name


def device_time_total(prof) -> float:
    """`device_time_by_name`'s total alone, in device microseconds: no
    per-name sums, each event's type compared as an enum (a fleet
    bucket's trace holds ~10^5 events)."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e3


def pgo_kernel_cases(family: str, g) -> dict:
    """The phase's kernel rows at the family's shapes on its full-size
    plans (the i-side and the j-side of kernels 1-3, kernel 6 over the
    poses), f32 and f64, each named with the tag " pgo": seeded random
    rows as in `shape_cases`; the library yardsticks cuSPARSE CSR
    products for 2 and 3 and `torch.einsum` for 6."""
    from megba_tpu_torch.ops import segtiles

    d = g.poses0.shape[1]
    n_poses = g.poses0.shape[0]
    _, plans = segtiles.make_dual_plans(g.edge_i, g.edge_j, n_poses, n_poses,
                                        DEVICE)
    for side, plan in (("i", plans.cam), ("j", plans.pt)):
        log(f"pgo {family} {side} side ({d}, {d}): {plan.num_segments} "
            f"segments, {plan.n_slots} slots; kernels 1 and 3 "
            f"{launch_shape(plan)}")
    cases = shape_cases(d, d, plans.cam, f"pgo_{family}_i")
    for name, sides in shape_cases(d, d, plans.pt,
                                   f"pgo_{family}_j").items():
        cases[name] = cases[name] + sides
    gen = torch.Generator(device=DEVICE).manual_seed(d)
    for dtype, elt, suffix in ((torch.float32, 4, ""),
                               (torch.float64, 8, "[f64]")):
        Hrows = torch.randn((d * d, n_poses), generator=gen, device=DEVICE,
                            dtype=dtype)
        x = torch.randn((d, n_poses), generator=gen, device=DEVICE,
                        dtype=dtype)
        Minv = Hrows.T.reshape(n_poses, d, d)
        cases[f"fused_block_diag_apply({d}){suffix}"] = [_case(
            f"pgo_{family}", (Hrows, x), (d * d + 2 * d) * n_poses * elt,
            2 * d * d * n_poses,
            lambda Minv=Minv, x=x: lambda: torch.einsum("nij,jn->in", Minv,
                                                        x),
            ref64=dtype == torch.float32)]
    return {f"{name} pgo": sides for name, sides in cases.items()}


def pgo_phase(keep: dict) -> dict:
    """Phase 10: the pose-graph driver (models/pgo.py) on the card.  The
    f64 paths kernels against plain on the small graphs, the g2o round
    trip, the full-size f32 and f64 solves of each family, then the
    kernel rows at (6, 6) / 6 and (7, 7) / 7, each carrying its launches
    from the full-size run of its arm and family, kernel 2's (both arms)
    also with its device time.  Returns the rows; `keep` receives the
    full-size SE(3) graph and its f64 solve (`PGO_KEEP`) for phase 11."""
    t0 = time.perf_counter()
    small = {f: pgo_graph(f, PGO_SMALL) for f in PGO_FACTORS}
    pgo_f64_paths(small)
    pgo_g2o_round_trip(small["se3"])
    del small
    steps = [time.perf_counter()]
    rows = {}
    for family in PGO_FACTORS:
        g = pgo_graph(family, PGO_FULL)
        kept = {}
        launches = {arm: pgo_full_solve(
            family, g, dtype, kept if (family, arm) == PGO_KEEP else None)
            for arm, dtype in (("f32", np.float32), ("f64", np.float64))}
        if kept:
            keep.update(kept, graph=g)
        steps.append(time.perf_counter())
        cases = pgo_kernel_cases(family, g)
        fam_rows = measure_rows(cases)
        d = g.poses0.shape[1]
        row_device_times(fam_rows, cases, [
            f"coupling_expand({d},{d}){arm} pgo" for arm in ("", "[f64]")])
        for name, row in fam_rows.items():
            key = untagged(name)
            arm = "f64" if key.endswith("[f64]") else "f32"
            row["launches"] = launches[arm].get(key.replace("[f64]", ""))
        rows.update(fam_rows)
        del g
        torch.cuda.empty_cache()
        steps.append(time.perf_counter())
    log(f"pgo phase: {time.perf_counter() - t0:.1f} s (f64 paths and g2o "
        f"{steps[0] - t0:.1f} s; per family full-size solves, kernel rows: "
        + ", ".join(f"{b - a:.1f}" for a, b in zip(steps, steps[1:]))
        + " s)")
    return rows



# ---------------------------------------------------------------------------
# Phase 11: durable single-host solves
# ---------------------------------------------------------------------------

# LM iterations a chunk: the venice and trafalgar-sized solves snapshot
# every CHUNK_BA, the full-size pose graph every CHUNK_PGO.
CHUNK_BA = 2
CHUNK_PGO = 5
# The chunked venice solve's final cost against the straight one's.
CHUNKED_COST_RTOL = 1e-6
# The f64 chunked gate's NaN burst, global iterations [1, 3): its window
# spans the first chunk boundary.
CHUNK_BURST = (1, 3)
# The triage scenes: venice's sizes (and trafalgar's for the f64 gate)
# with degeneracies injected by io.synthetic's knobs.
TRIAGE_KNOBS = dict(n_orphan_points=1000, n_behind_camera=1000,
                    n_disconnect=1)
TRIAGE_KNOBS_SMALL = dict(n_orphan_points=100, n_behind_camera=100,
                          n_disconnect=1)
KILL_WORKER = ROOT / "scripts" / "torch_killresume_worker.py"
KILL_ARGS = ("--device", "cuda:0", "--scene", "trafalgar")


@contextlib.contextmanager
def record_chunks(module, name: str):
    """Wrap `module.name`, the per-chunk solve of a chunked driver (it is
    imported at call time), for the calls made inside: yields a list of
    {"res", "seconds", "timer"} (a fresh utils.timing.PhaseTimer a chunk
    for flat_solve, None for solve_pgo), one a chunk."""
    from megba_tpu_torch.utils.timing import PhaseTimer

    inner = getattr(module, name)
    chunks = []

    def recorded(*args, **kwargs):
        timer = None
        if name == "flat_solve":
            timer = kwargs["timer"] = PhaseTimer()
        t = time.perf_counter()
        res = inner(*args, **kwargs)
        chunks.append(dict(res=res, seconds=time.perf_counter() - t,
                           timer=timer))
        return res

    setattr(module, name, recorded)
    try:
        yield chunks
    finally:
        setattr(module, name, inner)


@contextlib.contextmanager
def record_snapshots():
    """The host seconds and bytes of each snapshot the chunked drivers
    write inside (save_state: serialise, fsync, rename): a list of
    (seconds, bytes) the context yields."""
    from megba_tpu_torch.algo import checkpointed

    inner = checkpointed.save_state
    saves = []

    def recorded(path, *args, **kwargs):
        t = time.perf_counter()
        inner(path, *args, **kwargs)
        saves.append((time.perf_counter() - t, Path(path).stat().st_size))

    checkpointed.save_state = recorded
    try:
        yield saves
    finally:
        checkpointed.save_state = inner


def chunk_words(chunks, saves) -> str:
    """Each chunk's host seconds of re-lowering (the timer's "lowering",
    "sort" and "plan" phases, and the first two apart), its LM loop
    ("dispatch") and its whole call, and each snapshot's save seconds
    and bytes, for the log."""
    parts = []
    for i, (c, (ss, nb)) in enumerate(zip(chunks, saves)):
        tot = c["timer"].totals if c["timer"] is not None else {}
        lower = sum(tot.get(k, 0.0)
                    for k in ("lowering", "sort", "plan", "coarse_plan"))
        lm = (f"re-lowering {lower:.3f} s (lowering "
              f"{tot.get('lowering', 0.0):.3f}, plan "
              f"{tot.get('plan', 0.0):.3f}), LM loop "
              f"{tot.get('dispatch', 0.0):.3f} s, " if tot else "")
        parts.append(f"chunk {i}: {c['res'].iterations} LM, {lm}call "
                     f"{c['seconds']:.3f} s, snapshot {ss:.4f} s "
                     f"{nb} bytes")
    return "; ".join(parts)


def chunked_solve(arrays, opt, kw, module, name: str, every: int):
    """One solve of a chunked driver (`solve_checkpointed`, or
    `solve_pgo_checkpointed` with `name="solve_pgo"`) on the card into a
    temporary snapshot, launches counted from zero: (result, wall,
    chunks, saves, launch counts)."""
    import tempfile

    from megba_tpu_torch import solve_checkpointed, solve_pgo_checkpointed

    driver = (solve_pgo_checkpointed if name == "solve_pgo"
              else functools.partial(solve_checkpointed, None))
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        reset_launch_counts()
        with record_chunks(module, name) as chunks, \
                record_snapshots() as saves:
            t = time.perf_counter()
            res = driver(*arrays, opt,
                         checkpoint_path=str(Path(tmp) / "snapshot.npz"),
                         checkpoint_every=every, device=DEVICE, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    return res, wall, chunks, saves, launch_counts()


def same_counts(what: str, a, b) -> None:
    """Equal LM, accepted and PCG counts and status (recoveries where the
    results carry them)."""
    fields = ("iterations", "accepted", "pcg_iterations", "status",
              "recoveries")
    ka = tuple(getattr(a, f, None) for f in fields)
    kb = tuple(getattr(b, f, None) for f in fields)
    if ka != kb:
        raise AssertionError(f"{what}: (LM, accepted, PCG, status, "
                             f"recoveries) {ka} against {kb}")


def trial_gate(what: str, a, b) -> float:
    """Two BA runs agree: `same_counts`, the accept and recovery traces
    equal, the trial costs at `F64_COST_RTOL` where finite and NaN at the
    same iterations.  Returns the trial costs' largest relative gap."""
    same_counts(what, a, b)
    k = a.iterations
    for f in ("accept", "recovery"):
        if not torch.equal(getattr(a.trace, f)[:k], getattr(b.trace, f)[:k]):
            raise AssertionError(f"{what}: {f} traces differ")
    gap, _ = cost_gap(a.trace.cost[:k].numpy(), b.trace.cost[:k].numpy(),
                      what, np.zeros(k, bool))
    if not gap <= F64_COST_RTOL:
        raise AssertionError(f"{what}: trial costs {gap:.3e} apart")
    return gap


def chunked_venice(venice, straight) -> list:
    """11.1: venice f32 IMPLICIT through `solve_checkpointed` in chunks of
    `CHUNK_BA`, against phase 7's straight IMPLICIT run (`straight`: its
    launch counts, result and wall).  Returns each chunk's re-lowering
    (`relowering_of`) for phase 14.  Each chunk starts with one
    linearisation at the carried parameters (algo/lm.py's pre-loop
    `linearize`), so kernel 1 launches twice more a chunk boundary and
    kernels 2-3 as often as straight; the launches must also be
    `expected_launches` summed over the chunks."""
    from megba_tpu_torch import solve as solve_mod
    from megba_tpu_torch import status_name

    counts0, ref, wall0 = straight
    opt = solve_option(np.float32, "implicit")
    arrays, kw = solve_inputs(venice, "implicit", venice=True)
    res, wall, chunks, saves, counts = chunked_solve(
        arrays, opt, kw, solve_mod, "flat_solve", CHUNK_BA)
    same_counts("durable venice chunked vs straight", res, ref)
    c1, c_ref = float(res.cost), float(ref.cost)
    if not abs(c1 - c_ref) <= CHUNKED_COST_RTOL * abs(c_ref):
        raise AssertionError(f"durable venice: final cost {c1} against the "
                             f"straight run's {c_ref}")
    k = res.iterations
    ct, rt = res.trace.cost[:k], ref.trace.cost[:k]
    bitwise = ct.dtype == rt.dtype and torch.equal(ct, rt)
    gap = float(((ct.double() - rt.double()).abs() / rt.double().abs()).max())
    want = {}
    for c in chunks:
        for name, n in expected_launches("implicit", c["res"]).items():
            want[name] = want.get(name, 0) + n
    boundary = {"jtj_grad_reduce": 2 * (len(chunks) - 1)}
    extra = {n: counts[n] - counts0[n] for n in counts
             if counts[n] != counts0[n]}
    if counts != want or extra != {n: v for n, v in boundary.items() if v}:
        raise AssertionError(f"durable venice: launches {counts}, the code "
                             f"implies {want}; beyond the straight run's "
                             f"{extra}")
    log(f"durable venice f32 implicit: {len(chunks)} chunks of "
        f"{CHUNK_BA} LM, cost {float(res.initial_cost):.8e} -> {c1:.8e} "
        f"(straight {c_ref:.8e}), {k} LM ({res.accepted} accepted), "
        f"{res.pcg_iterations} PCG, status {status_name(res.status)}, as the "
        f"straight run; stitched trial costs {'bitwise' if bitwise else 'not bitwise'}"
        f" the straight run's (largest gap {gap:.3e}); wall chunked "
        f"{wall:.3f} s against straight {wall0:.3f} s ({wall / wall0:.2f}x); "
        f"launches {counts}: the straight run's plus "
        f"{boundary['jtj_grad_reduce']} of kernel 1 (one linearisation a "
        f"chunk boundary)")
    log("durable venice chunks: " + chunk_words(chunks, saves))
    return relowering_of(chunks)


def chunked_f64(scene) -> None:
    """11.2: the trafalgar-sized f64 scene under `ProblemOption()` with
    the LM cap `DEFAULT_LM_CAP` through `solve_checkpointed`, kernels
    against plain versions; then guarded with a NaN burst whose window
    (`CHUNK_BURST`) spans the first chunk boundary."""
    from megba_tpu_torch import make_nan_burst
    from megba_tpu_torch import solve as solve_mod

    arrays, _ = solve_inputs(scene, DEFAULT_PATH)
    n_edges = arrays[2].shape[0]
    cases = {
        "default": (solve_option(np.float64, DEFAULT_PATH), {}),
        "nan_burst_across_boundary": (
            solve_option(np.float64, "implicit_nan_burst"),
            dict(fault_plan=make_nan_burst(n_edges, NAN_EDGES_F64,
                                           *CHUNK_BURST))),
    }
    for case, (opt, kw) in cases.items():
        kern, _, chunks, _, _ = chunked_solve(arrays, opt, kw, solve_mod,
                                              "flat_solve", CHUNK_BA)
        with plain_path():
            plain, _, _, _, _ = chunked_solve(arrays, opt, kw, solve_mod,
                                              "flat_solve", CHUNK_BA)
        what = f"durable f64 {case}"
        gap = trial_gate(f"{what} kernels vs plain", kern, plain)
        words = check_path_outcome(
            what, "implicit_nan_burst" if kw else "implicit", kern,
            float(kern.initial_cost))
        log(f"{what}: {len(chunks)} chunks of {CHUNK_BA} LM, cost "
            f"{float(kern.initial_cost):.10e} -> {float(kern.cost):.10e}, "
            f"{kern.iterations} LM ({kern.accepted} accepted), "
            f"{kern.pcg_iterations} PCG, {words}; trial costs kernels vs "
            f"plain {gap:.3e}, the same counts, accepts, recoveries and "
            f"status")


def killresume_on_card() -> None:
    """11.3: the kill-resume worker on cuda:0 (trafalgar-sized f64, 8 LM
    in chunks of 2): one uninterrupted run and, beside it, a run
    SIGKILLed once its first snapshot lands and resumed; the results
    bitwise equal."""
    import tempfile

    from megba_tpu_torch.robustness.harness import (
        python_worker, run_to_completion, run_until_snapshot_then_kill)
    from megba_tpu_torch.utils.checkpoint import load_state

    import threading

    args = KILL_ARGS
    with tempfile.TemporaryDirectory() as tmp:
        ck_a, out_a = f"{tmp}/a.npz", f"{tmp}/a_result.npz"
        ck_b, out_b = f"{tmp}/b.npz", f"{tmp}/b_result.npz"
        ref = {}

        def reference() -> None:
            # The uninterrupted run, beside the killed one and its resume
            # (a process each on the one card).
            t0 = time.perf_counter()
            try:
                run_to_completion(python_worker(str(KILL_WORKER), ck_a,
                                                out_a, *args), timeout=300)
            except Exception as e:  # re-raised below
                ref["error"] = e
            ref["seconds"] = time.perf_counter() - t0

        thread = threading.Thread(target=reference)
        thread.start()
        try:
            argv = python_worker(str(KILL_WORKER), ck_b, out_b, *args)
            t = time.perf_counter()
            rc = run_until_snapshot_then_kill(argv, ck_b, timeout=300)
            t_kill = time.perf_counter() - t
            at = int(load_state(ck_b)["iteration"])
            if rc == 0 or Path(out_b).exists():
                raise AssertionError("durable kill: the worker was not "
                                     "killed")
            t = time.perf_counter()
            run_to_completion(argv, timeout=300)
            t_resume = time.perf_counter() - t
        finally:
            thread.join()
        if "error" in ref:
            raise ref["error"]
        t_ref = ref["seconds"]
        with np.load(out_a) as za, np.load(out_b) as zb:
            a = {k: za[k] for k in za.files}
            b = {k: zb[k] for k in zb.files}
    differ = [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(
        a[k], b[k], equal_nan=True))]
    if set(a) != set(b) or differ:
        raise AssertionError(f"durable kill: killed + resumed differs from "
                             f"the uninterrupted run in {differ}")
    log(f"durable kill-resume on cuda:0: reference run {t_ref:.1f} s "
        f"(beside the killed run and its resume), "
        f"SIGKILL (rc {rc}) {t_kill:.1f} s after start with the snapshot "
        f"at iteration {at}, resume {t_resume:.1f} s; {int(a['iterations'])} "
        f"LM ({int(a['accepted'])} accepted), cost {float(a['cost']):.10e}; "
        f"cameras, points, counts and the stitched trace bitwise the "
        f"uninterrupted run's")


def chunked_pgo(kept: dict) -> None:
    """11.4: phase 10's full-size SE(3) graph at f64 through
    `solve_pgo_checkpointed` in chunks of `CHUNK_PGO`, against phase
    10's straight solve: equal counts and status, final cost within
    `F64_COST_RTOL`, launches `pgo_expected_launches` summed over the
    chunks."""
    from megba_tpu_torch import AlgoOption, ProblemOption, status_name
    from megba_tpu_torch.models import pgo
    from megba_tpu_torch.ops import fused, segtiles

    g, ref, wall0 = kept["graph"], kept["res"], kept["wall"]
    opt = ProblemOption(dtype=np.float64,
                        algo_option=AlgoOption(max_iter=PGO_FULL_LM))
    res, wall, chunks, saves, _ = chunked_solve(
        (g.poses0, g.edge_i, g.edge_j, g.meas), opt,
        dict(factor=PGO_FACTORS["se3"]), pgo, "solve_pgo", CHUNK_PGO)
    shapes = {k: v for k, v in {**segtiles.shape_launch_counts(),
                                **fused.shape_launch_counts()}.items() if v}
    want = {}
    for c in chunks:
        for k, v in pgo_expected_launches(c["res"], 1, 6).items():
            want[k] = want.get(k, 0) + v
    if shapes != want:
        raise AssertionError(f"durable pgo: launches {shapes}, the code "
                             f"implies {want}")
    same_counts("durable pgo chunked vs straight", res, ref)
    c1, c_ref = float(res.cost), float(ref.cost)
    if not abs(c1 - c_ref) <= F64_COST_RTOL * abs(c_ref):
        raise AssertionError(f"durable pgo: final cost {c1} against the "
                             f"straight run's {c_ref}")
    log(f"durable pgo se3 f64: {len(chunks)} chunks of {CHUNK_PGO} LM, "
        f"cost {float(res.initial_cost):.10e} -> {c1:.10e} (straight "
        f"{c_ref:.10e}, {abs(c1 - c_ref) / c_ref:.3e} apart), "
        f"{res.iterations} LM ({res.accepted} accepted), "
        f"{res.pcg_iterations} PCG, status {status_name(res.status)}, as the "
        f"straight run; wall chunked {wall:.3f} s against straight {wall0:.3f} s; "
        f"launches {shapes} (pgo_expected_launches summed over the chunks)")
    log("durable pgo chunks: " + chunk_words(chunks, saves))


def triage_full_width(trafalgar_cfg: dict) -> None:
    """11.5: pre-flight triage on a venice-sized scene with degeneracies
    (`TRIAGE_KNOBS`): REJECT raises ProblemRejected with no launch and no
    device allocation, after the timer's triage phase alone (the host
    seconds of triage; the findings from the exception's report); REPAIR
    solves with the venice f32 options, with no
    recovery and no preconditioner fallback, to a finite cost below the
    initial; then a trafalgar-sized f64 REPAIR solve, kernels against
    plain versions under the f64 gates."""
    from megba_tpu_torch import (ProblemRejected, TriageAction, TriagePolicy,
                                 flat_solve, status_name)
    from megba_tpu_torch.utils.timing import PhaseTimer

    repair = TriagePolicy(on_degenerate=TriageAction.REPAIR)
    scene = make_scene(dict(VENICE, **TRIAGE_KNOBS), np.float32)
    arrays = (scene.cameras0, scene.points0, scene.obs, scene.cam_idx,
              scene.pt_idx)

    torch.cuda.synchronize()
    reset_launch_counts()
    mem0 = torch.cuda.memory_allocated()
    timer = PhaseTimer()
    opt = solve_option(np.float32, "implicit", lm=VENICE_LM)
    try:
        flat_solve(None, *arrays, opt, device=DEVICE, timer=timer,
                   triage=TriagePolicy())
    except ProblemRejected as exc:
        rejected = exc
    else:
        raise AssertionError("durable triage: REJECT solved the problem")
    launched = {k: v for k, v in launch_counts().items() if v}
    mem1 = torch.cuda.memory_allocated()
    if launched or mem1 != mem0 or list(timer.totals) != ["triage"]:
        raise AssertionError(f"durable triage: REJECT launched {launched}, "
                             f"device memory {mem0} -> {mem1} bytes, "
                             f"phases {list(timer.totals)}")
    log(f"durable triage REJECT: ProblemRejected ({str(rejected)[:160]}) "
        f"after the triage phase alone ({timer.totals['triage']:.3f} s on "
        f"the host for {scene.obs.shape[0]} edges), no launch, device "
        f"memory unchanged at {mem0} bytes; findings "
        f"{rejected.report.counts()}, {rejected.report.n_components} "
        "components")

    timer = PhaseTimer()
    reset_launch_counts()
    t = time.perf_counter()
    res = flat_solve(None, *arrays, opt, device=DEVICE, timer=timer,
                     triage=repair)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    k = res.iterations
    fallback = res.trace.precond_fallback[:k].tolist()
    c0, c1 = float(res.initial_cost), float(res.cost)
    if res.recoveries or any(fallback) or not (np.isfinite(c1) and c1 < c0):
        raise AssertionError(f"durable triage REPAIR: cost {c0} -> {c1}, "
                             f"{res.recoveries} recoveries, precond_fallback "
                             f"{fallback}")
    events = {n: v["calls"] for n, v in timer.as_dict().items()
              if n.startswith("triage_")}
    log(f"durable triage REPAIR venice f32: cost {c0:.8e} -> {c1:.8e}, {k} "
        f"LM ({res.accepted} accepted), {res.pcg_iterations} PCG, status "
        f"{status_name(res.status)}, no recovery, precond_fallback {fallback}; "
        f"flat_solve {wall:.3f} s (triage {timer.totals['triage']:.3f} s); "
        f"timer events {events}")
    del scene, arrays, res
    torch.cuda.empty_cache()

    small = make_scene(dict(trafalgar_cfg, **TRIAGE_KNOBS_SMALL), np.float64)
    arrays = (small.cameras0, small.points0, small.obs, small.cam_idx,
              small.pt_idx)
    opt = solve_option(np.float64, DEFAULT_PATH)
    kern = flat_solve(None, *arrays, opt, device=DEVICE, triage=repair)
    with plain_path():
        plain = flat_solve(None, *arrays, opt, device=DEVICE, triage=repair)
    gap = trial_gate("durable triage REPAIR f64 kernels vs plain", kern,
                     plain)
    log(f"durable triage REPAIR f64: cost {float(kern.initial_cost):.10e} -> "
        f"{float(kern.cost):.10e}, {kern.iterations} LM ({kern.accepted} "
        f"accepted), {kern.pcg_iterations} PCG, status "
        f"{status_name(kern.status)}; trial "
        f"costs kernels vs plain {gap:.3e}, the same counts and status")


def durable_phase(venice, trafalgar64, straight, pgo_kept) -> list:
    """Phase 11: the chunked drivers, the kill-resume and pre-flight
    triage on the card.  Returns the chunked venice run's re-lowering
    per chunk."""
    t0 = time.perf_counter()
    steps = [t0]
    chunked = chunked_venice(venice, straight)
    steps.append(time.perf_counter())
    chunked_f64(trafalgar64)
    steps.append(time.perf_counter())
    killresume_on_card()
    steps.append(time.perf_counter())
    chunked_pgo(pgo_kept)
    steps.append(time.perf_counter())
    triage_full_width(TRAFALGAR)
    steps.append(time.perf_counter())
    log(f"durable phase: {steps[-1] - t0:.1f} s (chunked venice, f64 "
        "gates, kill-resume, chunked pose graph, triage: "
        + ", ".join(f"{b - a:.1f}" for a, b in zip(steps, steps[1:]))
        + " s)")
    return chunked


# ---------------------------------------------------------------------------
# Phase 12: the fleet service
# ---------------------------------------------------------------------------

# The full-size fleet: 1024 problems of 128-1024 points (16-128 cameras,
# ~256-3,600 edges each, ~1.6M real edges), the JAX package's
# `make_fleet` at seed 0.
FLEET_N = 1024
FLEET_SIZES = (128, 1024)
# The first FLEET_SMALL problems: the queue under chaos; the first
# FLEET_VS_PLAIN: kernels against plain (LM-capped at FLEET_LM_CAP,
# before the cost floor; cut from 64 to 32, then to 16, for the script's
# time limit).
FLEET_SMALL = 64
FLEET_VS_PLAIN = 16
FLEET_LM_CAP = 4
# The bf16 rung's cap: its PCG stops at 1e-3 of the RHS energy, so each
# LM iteration moves a kernel run's final cost from the plain run's by
# ~1e-4 (one of 64 problems 1.8e-3 apart after 4 iterations on the H100;
# under a one-ulp change of the observations 2.9e-4 after 2, 8.5e-4
# after 4: scripts/torch_fleet_rung_sensitivity.py), where phase 6's
# final-cost rule is 1e-3.
FLEET_BF16_LM_CAP = 2
# Problems of one bucket each solved as a fleet of one, bitwise against
# its lane in the batch.
FLEET_BITWISE = 2
# The f32 re-runs of the EXPLICIT and fused paths take the first
# problems only (their f64 runs take the whole fleet; cut from 64 for the
# script's time limit).
FLEET_F32_RERUN = 32
FLEET_REPORTS = ROOT / "chiprun_out" / "fleet_reports.jsonl"
# torch.profiler traces only buckets of this many lanes and more (the
# fleet's three 512-lane buckets, where most of its work is): each
# profiled bucket costs seconds of the profiler's start, stop and event
# reading, and the small ones are launch-bound anyway.
FLEET_PROFILED_LANES = 512
# The option paths (`FLEET_OPTION_PATHS`) run on the first problems of
# the fleet (the coupling paths on all of them), at most FLEET_OPTION_LM
# LM iterations (both cuts, from 256 problems and ProblemOption()'s cap,
# for the script's time limit).
FLEET_OPTION_N = 128
FLEET_OPTION_LM = 4
# Problems solved one by one against their batch (12.2; 32 until PR 21).
FLEET_SERIAL = 16
FLEET_KERNELS = ("jtj_grad_reduce", "coupling_expand", "coupling_reduce",
                 "fused_block_diag_apply")
# The lane-batched LM's coupling paths: name -> (ComputeKind name,
# fused_kernels).  "implicit" is ProblemOption()'s; the others run
# kernels 4-5, 7 and 8 at the bucket union.
FLEET_PATHS = {"implicit": ("IMPLICIT", False),
               "explicit": ("EXPLICIT", False),
               "fused_implicit": ("IMPLICIT", True),
               "fused_explicit": ("EXPLICIT", True)}
# The kernels that carry one coupling direction on each path.
FLEET_DIRECTION_KERNELS = {
    "implicit": ("coupling_expand", "coupling_reduce"),
    "explicit": ("seg_expand", "seg_reduce"),
    "fused_implicit": ("fused_coupling_apply_implicit",),
    "fused_explicit": ("fused_coupling_apply",)}
# The path whose full-size f64 / f32 run gives a union row its launches.
FLEET_ROW_PATH = {"seg_reduce": "explicit", "seg_expand": "explicit",
                  "fused_coupling_apply_implicit": "fused_implicit",
                  "fused_coupling_apply": "fused_explicit"}
# The option paths beside the coupling paths: name -> (ComputeKind name,
# fused_kernels, dtype, ProblemOption fields, SolverOption fields, enums
# by name).  Together they launch every precision arm of kernels 2, 3, 6,
# 7 and 8 the lane-batched LM runs, and kernel 4 on SCHUR_DIAG's
# correction rows.
FLEET_OPTION_PATHS = {
    "implicit_mixed64": ("IMPLICIT", False, np.float64,
                         dict(mixed_precision_pcg=True), {}),
    "fused_explicit_mixed": ("EXPLICIT", True, np.float32,
                             dict(mixed_precision_pcg=True), {}),
    "fused_implicit_bf16": ("IMPLICIT", True, np.float32, {},
                            dict(bf16=True)),
    "implicit_bf16": ("IMPLICIT", False, np.float32, {}, dict(bf16=True)),
    "explicit_schur_diag": ("EXPLICIT", False, np.float64, {},
                            dict(preconditioner="SCHUR_DIAG")),
    "implicit_neumann": ("IMPLICIT", False, np.float64, {},
                         dict(precond="NEUMANN", neumann_order=2)),
    "implicit_plain": ("IMPLICIT", False, np.float64,
                       dict(use_schur=False), {}),
}
# Union rows of the option paths' arms: row -> (path, the key of its
# launches in that path's full-size run).  Kernel 4's SCHUR_DIAG row
# counts the launches made on the correction rows alone.
FLEET_ARM_ROWS = {
    "coupling_expand[mixed64] fleet": ("implicit_mixed64",
                                       "coupling_expand[mixed64]"),
    "coupling_reduce[mixed64] fleet": ("implicit_mixed64",
                                       "coupling_reduce[mixed64]"),
    "coupling_expand[bf16] fleet": ("implicit_bf16", "coupling_expand[bf16]"),
    "coupling_reduce[bf16] fleet": ("implicit_bf16", "coupling_reduce[bf16]"),
    "fused_coupling_apply_implicit[bf16] fleet": (
        "fused_implicit_bf16", "fused_coupling_apply_implicit[bf16]"),
    "fused_coupling_apply[mixed] fleet": ("fused_explicit_mixed",
                                          "fused_coupling_apply[mixed]"),
    "fused_block_diag_apply[bf16] fleet": ("fused_implicit_bf16",
                                           "fused_block_diag_apply[bf16]"),
    "seg_reduce[f64] fleet schur_diag": ("explicit_schur_diag",
                                         "seg_reduce schur_diag"),
}
FLEET_TRACE = ROOT / "chiprun_out" / "fleet_trace.json"
FLEET_METRICS = ROOT / "chiprun_out" / "fleet_metrics.prom"
FLEET_FLIGHT = ROOT / "chiprun_out" / "fleet_flight.jsonl"
PLANE_KNOBS = ("MEGBA_METRICS", "MEGBA_TRACE", "MEGBA_FLIGHT")


def fleet_problems(n: int, dtype):
    from megba_tpu_torch import FleetProblem
    from megba_tpu_torch.io.synthetic import make_fleet

    t = time.perf_counter()
    fl = make_fleet(n, size_range=FLEET_SIZES, seed=0, dtype=dtype)
    probs = [FleetProblem.from_synthetic(s, name=f"fleet{i}")
             for i, s in enumerate(fl)]
    edges = sum(p.obs.shape[0] for p in probs)
    log(f"fleet: {n} problems of {FLEET_SIZES[0]}-{FLEET_SIZES[1]} points, "
        f"{edges} edges, {np.dtype(dtype).name}, made in "
        f"{time.perf_counter() - t:.1f} s")
    return probs


def fleet_path(path: str):
    """(ComputeKind name, fused_kernels, dtype or None, ProblemOption
    fields, SolverOption fields) of a coupling or option path."""
    if path in FLEET_PATHS:
        return (*FLEET_PATHS[path], None, {}, {})
    return FLEET_OPTION_PATHS[path]


def fleet_coupling_path(path: str) -> str:
    """The coupling path (`FLEET_PATHS`) a path's products run on."""
    kind, fk = fleet_path(path)[:2]
    return next(k for k, v in FLEET_PATHS.items() if v == (kind, fk))


def fleet_rung(path: str):
    """A path's precision rung: "mixed", "bf16" or None."""
    _, _, _, top, so = fleet_path(path)
    return ("bf16" if so.get("bf16") else
            "mixed" if top.get("mixed_precision_pcg") else None)


def fleet_option(dtype, path: str = "implicit", solver=None, **kw):
    """`ProblemOption()` at `dtype` on one of `FLEET_PATHS` or
    `FLEET_OPTION_PATHS` (its other fields the defaults; `solver` more
    SolverOption fields, `kw` more ProblemOption fields)."""
    from megba_tpu_torch import (ComputeKind, PrecondKind,
                                 PreconditionerKind, ProblemOption,
                                 SolverOption)

    kind, fk, _, top, so = fleet_path(path)
    enums = {"precond": PrecondKind, "preconditioner": PreconditionerKind}
    so = {k: enums[k][v] if k in enums else v for k, v in so.items()}
    so.update(solver or {})
    return ProblemOption(dtype=dtype, compute_kind=ComputeKind[kind],
                         solver_option=SolverOption(fused_kernels=fk, **so),
                         **top, **kw)


def fleet_expected_launches(results, path: str = "implicit") -> dict:
    """The launches the lane-batched solve (algo/lanes.py) implies for one
    bucket on `path`, from its lanes' traces alone: the batch runs LM
    iteration k while any lane is live (k < its iterations), its PCG n_k
    iterations (the most of the live lanes'), and relinearises after k
    when a live lane accepted or recovered.  The Chronopoulos-Gear PCG
    of n iterations (cold start) runs n + 1 S.p products (two coupling
    directions and one fused_block_diag_apply each) and n + 1 M^-1
    applies (kernel 6); the reduced right-hand side and the
    back-substitution one direction each: 2n + 4 directions, each one
    launch of every kernel of `FLEET_DIRECTION_KERNELS` of the path's
    coupling path (IMPLICIT unfused: coupling_expand and coupling_reduce;
    EXPLICIT unfused: seg_expand and seg_reduce; fused: one fused
    kernel).  NEUMANN of order m makes each M^-1 apply m S.p products and
    m + 1 base applies; the bf16 rung's textbook body runs n S.p
    products and n + 1 M^-1 applies (kernel 6's bf16 arm with fused
    kernels, no kernel without); the plain solve n + 1 products of two
    directions and one kernel 6 each, and n + 1 M^-1 applies, with no
    right-hand side or back-substitution.  A rung's equilibration
    gathers its two scales (2 seg_expand) a PCG solve, SCHUR_DIAG sums
    its correction rows in 9 seg_reduce.  The gain ratio adds 2
    coupling_expand, a linearisation 2 jtj_grad_reduce.  Keys "name[arm]"
    count a rung's arm launches, "seg_reduce schur_diag" the correction
    rows' kernel 4."""
    _, fused, dtype, top, so = fleet_path(path)
    rung = fleet_rung(path)
    plain = top.get("use_schur") is False
    order = so.get("neumann_order", 0) if so.get("precond") == "NEUMANN" else 0
    k_max = max(r.iterations for r in results)
    lin = 1
    directions = k6 = k6_bf16 = 0
    for k in range(k_max):
        live = [r for r in results if r.iterations > k]
        n = max(int(r.trace.pcg_iters[k]) for r in live)
        if plain:
            directions += 2 * (n + 1)
            k6 += 2 * n + 2
        elif rung == "bf16":
            directions += 2 * n + 2
            applies = n + 1 if fused else 0
            k6_bf16 += applies
            k6 += n + applies
        else:
            products = (n + 1) * (1 + order)
            directions += 2 * products + 2
            k6 += products + (n + 1) * (1 + order)
        if any(bool(r.trace.accept[k]) or bool(r.trace.recovery[k])
               for r in live):
            lin += 1
    out = {"jtj_grad_reduce": 2 * lin, "coupling_expand": 2 * k_max,
           "fused_block_diag_apply": k6}
    direction_kernels = FLEET_DIRECTION_KERNELS[fleet_coupling_path(path)]
    for name in direction_kernels:
        out[name] = out.get(name, 0) + directions
    if rung is not None:
        out["seg_expand"] = out.get("seg_expand", 0) + 2 * k_max
        arm = "mixed64" if rung == "mixed" and dtype == np.float64 else rung
        for name in direction_kernels:
            out[f"{name}[{arm}]"] = directions
        if k6_bf16:
            out["fused_block_diag_apply[bf16]"] = k6_bf16
    if so.get("preconditioner") == "SCHUR_DIAG":
        out["seg_reduce"] = out.get("seg_reduce", 0) + 9 * k_max
        out["seg_reduce schur_diag"] = 9 * k_max
    return out


@contextlib.contextmanager
def record_buckets(profile: bool = False):
    """Record every lane-batched solve run inside (each bucket of a
    `solve_many` or a queue dispatch): its wall (synchronised), its
    launches per kernel and per arm, the kernel 4 launches SCHUR_DIAG's
    correction rows made (`lanes._schur_diag_rows` wrapped), its
    `LaneSolve`, and with `profile` its device busy share under
    torch.profiler (device activity only) where the bucket has
    `FLEET_PROFILED_LANES` lanes or more (None elsewhere).  Yields the
    list of records."""
    from megba_tpu_torch.algo import lanes

    inner, inner_rows = lanes.lane_lm_solve, lanes._schur_diag_rows
    records = []
    correction = [0]

    def rows(*args, **kw):
        before = launch_counts()["seg_reduce"]
        out = inner_rows(*args, **kw)
        correction[0] += launch_counts()["seg_reduce"] - before
        return out

    def recorded(*args, **kw):
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        torch.cuda.synchronize()
        t_in = time.perf_counter()
        reset_launch_counts()
        correction[0] = 0
        traced = profile and args[2].shape[0] >= FLEET_PROFILED_LANES
        ctx = (prof_ctx(activities=[ProfilerActivity.CUDA]) if traced
               else contextlib.nullcontext())
        with ctx as prof:
            t = time.perf_counter()
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        busy = None
        if traced:
            busy = device_time_total(prof) / 1e6 / wall
        records.append(dict(solve=out, wall=wall, busy=busy,
                            overhead=time.perf_counter() - t_in - wall,
                            launches={k: v for k, v in launch_counts().items()
                                      if v},
                            arms={k: v for k, v in arm_launch_counts().items()
                                  if v},
                            correction=correction[0]))
        return out

    lanes.lane_lm_solve, lanes._schur_diag_rows = recorded, rows
    try:
        yield records
    finally:
        lanes.lane_lm_solve, lanes._schur_diag_rows = inner, inner_rows


def fleet_solve(probs, opt, profile: bool = False, **kw):
    """`solve_many` on the card, each bucket recorded; returns (results,
    wall, records)."""
    from megba_tpu_torch import solve_many

    with record_buckets(profile) as records:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = solve_many(probs, opt, device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return res, wall, records


def check_bucket_launches(what: str, res, records,
                          path: str = "implicit") -> dict:
    """Each record's launches are exactly `fleet_expected_launches` of its
    bucket's lanes on `path` and the batch's own counts agree with them;
    returns the launches summed over the buckets."""
    by_bucket = {}
    for r in res:
        by_bucket.setdefault((str(r.shape), r.lanes), []).append(r)
    if len(records) != len(by_bucket):
        raise AssertionError(f"{what}: {len(records)} batched solves for "
                             f"{len(by_bucket)} buckets")
    total = {}
    for rec, ((bucket, lanes), lane_res) in zip(records, by_bucket.items()):
        want = fleet_expected_launches(lane_res, path)
        # The kernels' launches, and the arms and correction rows the
        # path's traces speak for.
        seen = dict(rec["launches"])
        seen.update({k: rec["arms"].get(k, 0) for k in want if "[" in k})
        if "seg_reduce schur_diag" in want:
            seen["seg_reduce schur_diag"] = rec["correction"]
        solve = rec["solve"]
        own = dict(lm=solve.lm_iterations, pcg=solve.pcg_iterations,
                   lin=solve.linearizations)
        if (seen != want
                or own["lm"] != max(r.iterations for r in lane_res)
                or 2 * own["lin"] != want["jtj_grad_reduce"]):
            raise AssertionError(
                f"{what} {bucket}: launches {seen}, the lanes' "
                f"traces imply {want}; the batch's own counts {own}")
        rec.update(bucket=bucket, lanes=lanes, real=len(lane_res),
                   lm=own["lm"], pcg=sum(own["pcg"]), seen=seen)
        for k, v in seen.items():
            total[k] = total.get(k, 0) + v
    return total


def fleet_gate(what: str, res) -> None:
    from megba_tpu_torch import SolveStatus

    for r in res:
        c0, c1 = float(r.initial_cost), float(r.cost)
        if not (np.isfinite(c1) and c1 <= c0) or (
                r.status == int(SolveStatus.FATAL_NONFINITE)):
            raise AssertionError(f"{what} {r.name}: cost {c0} -> {c1}, "
                                 f"status {r.status_name}")


def fleet_full(probs, dtype, path: str = "implicit", profile: bool = True,
               once: bool = False):
    """12.1: the full-size fleet `probs` through `solve_many` under
    ProblemOption() at `dtype` on `path` (`FLEET_PATHS` or
    `FLEET_OPTION_PATHS`): per bucket its shape, lanes and real problems,
    LM and PCG counts, wall, launches (checked exact) and, with
    `profile`, from one more run under torch.profiler (bitwise the
    first), the device's busy share of its buckets of
    `FLEET_PROFILED_LANES` lanes and more; with `once` the one run is
    the profiled one (its walls under the profiler); the fleet's wall,
    problems a second, peak memory, lane and edge fill.  Returns
    (results, launches summed over the buckets, records, wall)."""
    from megba_tpu_torch import AlgoOption
    from megba_tpu_torch.serving import FleetStats

    opt = fleet_option(dtype, path)
    if path in FLEET_OPTION_PATHS:
        opt = dataclasses.replace(opt, algo_option=AlgoOption(
            max_iter=FLEET_OPTION_LM))
    fleet_solve(probs[:1], opt)  # first use of the path's code
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats = FleetStats()
    res, wall, records = fleet_solve(probs, opt, profile=profile and once,
                                     stats=stats)
    peak = torch.cuda.max_memory_allocated()
    what = f"fleet {path} {np.dtype(dtype).name}"
    launches = check_bucket_launches(what, res, records, path)
    fleet_gate(what, res)
    busy = []
    if profile and once and any(rec["busy"] is not None
                                for rec in records):
        busy = [rec["busy"] for rec in records]
        # The profiler's start, stop and event reading around each bucket
        # are not the fleet's work.
        overhead = sum(rec["overhead"] for rec in records)
        log(f"fleet {path} {np.dtype(dtype).name}: wall {wall:.3f} s under "
            f"the profiler, {wall - overhead:.3f} s without its start, stop "
            f"and event reading ({overhead:.3f} s)")
        wall -= overhead
        what += " (under the profiler)"
    elif profile:
        res_p, _, rec_p = fleet_solve(probs, opt, profile=True)
        busy = [rec["busy"] for rec in rec_p]
        for a, b in zip(res, res_p):
            if not (a.cost.tobytes() == b.cost.tobytes()
                    and a.cameras.tobytes() == b.cameras.tobytes()):
                raise AssertionError(f"{what}: the profiled run differs "
                                     f"from the first in {a.name}")
    for i, rec in enumerate(records):
        share = ("" if not busy or busy[i] is None
                 else f", device busy {busy[i]:.1%}")
        log(f"{what} bucket {rec['bucket']}: {rec['lanes']} lanes, "
            f"{rec['real']} problems, {rec['lm']} LM iterations, "
            f"{rec['pcg']} PCG iterations (batch), wall {rec['wall']:.3f} s"
            f"{share}; launches {rec['seen']} (as the lanes' traces "
            "imply)")
    d = stats.as_dict()
    lane_fill = d["problems"] / d["lane_slots"]
    edge_fill = d["edges_real"] / d["edge_slots"]
    n_stat = {}
    for r in res:
        n_stat[r.status_name] = n_stat.get(r.status_name, 0) + 1
    log(f"{what}: {len(probs)} problems in {len(records)} buckets, wall "
        f"{wall:.3f} s ({len(probs) / wall:.1f} problems/s), peak "
        f"{peak / 2**30:.2f} GiB, lane fill {lane_fill:.1%}, edge fill "
        f"{edge_fill:.1%}; statuses {n_stat}; LM iterations "
        f"{sum(r.iterations for r in res)}, PCG "
        f"{sum(r.pcg_iterations for r in res)} over the problems; "
        f"launches {launches}")
    return res, launches, records, wall


def fleet_serial(probs) -> None:
    """12.2: the first problems one by one through `flat_solve`, then as
    one `solve_many`, problems a second of each (the latter with
    telemetry, the reports of 12.5)."""
    from megba_tpu_torch import ProblemOption, flat_solve

    small = probs[:FLEET_SERIAL]
    opt = ProblemOption()
    flat_solve(None, *fleet_arrays(small[0]), opt, device=DEVICE)  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    serial = [flat_solve(None, *fleet_arrays(p), opt, device=DEVICE)
              for p in small]
    torch.cuda.synchronize()
    t_serial = time.perf_counter() - t
    FLEET_REPORTS.parent.mkdir(exist_ok=True)
    FLEET_REPORTS.unlink(missing_ok=True)
    tele = dataclasses.replace(opt, telemetry=str(FLEET_REPORTS))
    res, t_batch, _ = fleet_solve(small, tele)
    fleet_gate(f"fleet batched {len(small)}", res)
    gaps = [abs(float(a.cost) - float(b.cost)) / abs(float(a.cost))
            for a, b in zip(serial, res)]
    log(f"fleet serial vs batched, {len(small)} problems under "
        f"ProblemOption(): flat_solve one by one {t_serial:.3f} s "
        f"({len(small) / t_serial:.1f} problems/s), solve_many "
        f"{t_batch:.3f} s ({len(small) / t_batch:.1f} problems/s, "
        f"{t_serial / t_batch:.1f}x); final costs part by at most "
        f"{max(gaps):.3e} (the solo loop's reductions are not the "
        f"batch's); {nvidia_smi_line()}")
    fleet_reports(len(small))


def fleet_arrays(p):
    return (p.cameras, p.points, p.obs, p.cam_idx, p.pt_idx)


def fleet_reports(n: int) -> None:
    """12.5: the batched run's telemetry: one report a problem, read back
    by the port's summarize (--aggregate and --fleet)."""
    from megba_tpu_torch.observability import summarize

    lines = FLEET_REPORTS.read_text().splitlines()
    if len(lines) != n:
        raise AssertionError(f"fleet telemetry: {len(lines)} reports for "
                             f"{n} problems")
    reps = summarize.load_reports(str(FLEET_REPORTS))
    backend = "gpu" if DEVICE.type == "cuda" else "cpu"
    if any(r.fleet is None or r.backend.get("backend") != backend
           for r in reps):
        raise AssertionError("fleet telemetry: a report lacks its fleet "
                             f"block or the {backend} backend")
    log(f"fleet telemetry: {n} reports in {FLEET_REPORTS.relative_to(ROOT)}")
    log(summarize.aggregate_reports(reps))
    log(summarize.fleet_table(reps))


def fleet_kernels_vs_plain(probs, path: str = "implicit") -> None:
    """12.3: the first problems under ProblemOption()'s PCG on `path`
    with the LM cap, through the kernels and through the plain versions
    on the card, and then problems of one bucket each solved as a fleet
    of one, bitwise equal to its lane in the batch.  At f64 (`probs` of
    the path's dtype): trial costs at rtol 1e-9, equal counts, accepts,
    status and `precond_fallback` traces.  A rung's path starts from
    trust region 1: from 1e3 a one-ulp change of the observations moves
    the fleet's trial costs by up to 37 % at f32 (the first) and more
    after 4 LM iterations (scripts/torch_fleet_rung_sensitivity.py), at
    f64 by ~1e-7 (`solve_option` says why).  An f32 rung path
    runs phase 6's rules: its PCG phase 6's (at most 30 iterations, no
    refusal, stopped at 1e-6 of the RHS energy, floored at 1e-3 on the
    bf16 rung; ProblemOption()'s refuse ratio of 1 makes an f32 PCG's
    exit turn on rounding), the bf16 rung under `FLEET_BF16_LM_CAP`,
    the first trial cost within
    `FIRST_COST_RTOL` and the final cost within `FINAL_COST_RTOL`, both
    finite and below the initial."""
    from megba_tpu_torch import AlgoOption

    dtype = fleet_path(path)[2] or np.float64
    rung = fleet_rung(path)
    small = probs[:FLEET_VS_PLAIN]
    algo = dict(max_iter=FLEET_BF16_LM_CAP if rung == "bf16"
                else FLEET_LM_CAP)
    if rung is not None:
        algo["initial_region"] = 1.0
    solver = (dict(tol=1e-6, tol_relative=True, max_iter=30,
                   refuse_ratio=1e30) if dtype == np.float32 else None)
    opt = fleet_option(dtype, path, solver=solver,
                       algo_option=AlgoOption(**algo))
    kern, _, _ = fleet_solve(small, opt)
    with plain_path():
        plain, _, _ = fleet_solve(small, opt)
    if dtype == np.float32:
        fleet_f32_vs_plain(path, rung, kern, plain)
    else:
        fleet_f64_vs_plain(path, kern, plain)
    fleet_lanes_alone(path, opt, small, kern)


def fleet_f32_vs_plain(path: str, rung: str, kern, plain) -> None:
    """Phase 6's rules on each problem of an f32 rung path."""
    worst = [0.0, 0.0]
    for a, b in zip(kern, plain):
        c0 = float(a.initial_cost)
        first = abs(float(a.trace.cost[0]) - float(b.trace.cost[0])) / abs(
            float(b.trace.cost[0]))
        final = abs(float(a.cost) - float(b.cost)) / abs(float(b.cost))
        for c in (float(a.cost), float(b.cost)):
            if not (np.isfinite(c) and c < c0):
                raise AssertionError(f"fleet {path} kernels vs plain "
                                     f"{a.name}: cost {c0} -> {c}")
        if not (first <= FIRST_COST_RTOL[rung] and final <= FINAL_COST_RTOL):
            raise AssertionError(
                f"fleet {path} kernels vs plain {a.name}: first trial cost "
                f"gap {first:.3e} (limit {FIRST_COST_RTOL[rung]:g}), final "
                f"{final:.3e} (limit {FINAL_COST_RTOL:g})")
        worst = [max(worst[0], first), max(worst[1], final)]
    log(f"fleet {path} kernels vs plain f32, {len(kern)} problems, LM cap "
        f"{max(a.iterations for a in kern)}: first trial costs within {worst[0]:.3e} (limit "
        f"{FIRST_COST_RTOL[rung]:g}), final costs within {worst[1]:.3e} "
        f"(limit {FINAL_COST_RTOL:g}), all finite and below the initial; "
        f"PCG {sum(a.pcg_iterations for a in kern)} against the plain "
        f"versions' {sum(b.pcg_iterations for b in plain)}")


def fleet_f64_vs_plain(path: str, kern, plain) -> None:
    """Trial costs at rtol 1e-9, equal counts, accepts, status and
    `precond_fallback` traces on each problem of an f64 path."""
    worst = 0.0
    for a, b in zip(kern, plain):
        if (a.iterations, a.accepted, a.pcg_iterations, a.status) != (
                b.iterations, b.accepted, b.pcg_iterations, b.status):
            raise AssertionError(f"fleet {path} kernels vs plain {a.name}: "
                                 "counts differ")
        k = a.iterations
        if not all(torch.equal(getattr(a.trace, f)[:k],
                               getattr(b.trace, f)[:k])
                   for f in ("accept", "pcg_iters", "precond_fallback")):
            raise AssertionError(f"fleet {path} kernels vs plain {a.name}: "
                                 "traces differ")
        ca, cb = a.trace.cost[:k].numpy(), b.trace.cost[:k].numpy()
        gap = float(np.max(np.abs(ca - cb) / np.abs(cb)))
        if not gap <= F64_COST_RTOL:
            raise AssertionError(f"fleet {path} kernels vs plain {a.name}: "
                                 f"trial costs {gap:.3e} apart")
        worst = max(worst, gap)
    log(f"fleet {path} kernels vs plain f64, {len(kern)} problems, LM cap "
        f"{FLEET_LM_CAP}: trial costs within {worst:.3e}, equal counts, "
        "accepts, status and precond_fallback traces")


def fleet_lanes_alone(path: str, opt, small, kern) -> None:
    """Problems of the most populated bucket each solved as a fleet of
    one, bitwise equal to its lane in the batch."""
    buckets = {}
    for p, r in zip(small, kern):
        buckets.setdefault(str(r.shape), []).append((p, r))
    big = max(buckets.values(), key=len)
    mates = big[:FLEET_BITWISE]
    for p, r in mates:
        alone = fleet_solve([p], opt)[0][0]
        if alone.lanes != 1 or not all(
                bitwise_equal(torch.as_tensor(getattr(alone, f)),
                              torch.as_tensor(getattr(r, f)))
                for f in ("cameras", "points", "cost")) or not all(
                bitwise_equal(getattr(alone.trace, f), getattr(r.trace, f))
                for f in ("cost", "grad_inf_norm", "trust_region", "rho",
                          "accept", "pcg_iters", "pcg_r0_ratio",
                          "precond_fallback")):
            raise AssertionError(f"fleet {path} lane independence {p.name}: "
                                 f"alone differs from its lane {r.lane} of "
                                 f"{r.lanes}")
    log(f"fleet {path} lane independence: {len(mates)} problems of bucket "
        f"{mates[0][1].shape} ({mates[0][1].lanes} lanes), each solved as a "
        "fleet of one, bitwise equal to its lane (cameras, points, cost, "
        "trace)")


@contextlib.contextmanager
def armed_plane(flight_path=None, knobs=PLANE_KNOBS):
    """Arm the observability plane's `knobs` (MEGBA_FLIGHT to
    `flight_path`) with fresh process defaults; disarm and reset after."""
    import os

    from megba_tpu_torch.observability import flight, metrics, spans

    values = {"MEGBA_METRICS": "1", "MEGBA_TRACE": "1",
              "MEGBA_FLIGHT": str(flight_path)}
    saved = {k: os.environ.get(k) for k in knobs}

    def reset():
        metrics.reset_default_registry()
        spans.reset_default_recorder()
        flight.reset_default_recorder()

    reset()
    try:
        for k in knobs:
            os.environ[k] = values[k]
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset()


def fleet_armed(probs, ref, ref_records, ref_wall) -> None:
    """12.7: the full-size f64 fleet again with MEGBA_METRICS, MEGBA_TRACE
    and MEGBA_FLIGHT armed: bitwise the unarmed run `ref` (cameras,
    points, costs, traces, status) with equal launches a bucket; the
    fleet series count every problem, bucket and dispatch; the Chrome
    trace, written under chiprun_out/ and read back, has one
    `solve_bucket` span a dispatch; the Prometheus text is written
    beside it."""
    from megba_tpu_torch import observability as obs
    from megba_tpu_torch.observability import metrics, spans
    from megba_tpu_torch.observability.trace import TRACE_FIELDS

    opt = fleet_option(np.float64)
    FLEET_TRACE.parent.mkdir(exist_ok=True)
    FLEET_FLIGHT.unlink(missing_ok=True)
    with armed_plane(FLEET_FLIGHT):
        res, wall, records = fleet_solve(probs, opt)
        snap = obs.metrics_registry().snapshot()
        spans.write_chrome_trace(str(FLEET_TRACE),
                                 obs.span_recorder().spans())
    for a, b in zip(res, ref):
        if not (a.cameras.tobytes() == b.cameras.tobytes()
                and a.points.tobytes() == b.points.tobytes()
                and a.cost.tobytes() == b.cost.tobytes()
                and a.status == b.status and all(
                    bitwise_equal(getattr(a.trace, f), getattr(b.trace, f))
                    for f in TRACE_FIELDS)):
            raise AssertionError(f"fleet armed: {a.name} differs from the "
                                 "unarmed run")
    if [r["launches"] for r in records] != [r["launches"]
                                            for r in ref_records]:
        raise AssertionError("fleet armed: launches differ from the "
                             "unarmed run's")
    m = snap["metrics"]
    problems = sum(m["megba_fleet_problems_total"]["series"].values())
    batches = sum(m["megba_fleet_batches_total"]["series"].values())
    lm = sum(h["count"] for h in
             m["megba_solve_lm_iterations"]["series"].values())
    if (problems, batches, lm) != (len(probs), len(records), len(probs)):
        raise AssertionError(f"fleet armed: series count {problems} "
                             f"problems, {batches} batches, {lm} LM "
                             f"observations for {len(probs)} problems in "
                             f"{len(records)} dispatches")
    FLEET_METRICS.write_text(metrics.render_prometheus(snap))
    doc = json.loads(FLEET_TRACE.read_text())
    buckets = [e for e in doc["traceEvents"]
               if e["ph"] == "X" and e["name"] == "solve_bucket"]
    if doc.get("schema") != spans.SCHEMA or len(buckets) != len(records):
        raise AssertionError(f"fleet armed: the Chrome trace has "
                             f"{len(buckets)} solve_bucket spans for "
                             f"{len(records)} dispatches")
    log(f"fleet armed (metrics, spans, flight): {len(probs)} problems "
        f"bitwise the unarmed run with equal launches; wall {wall:.3f} s "
        f"armed against {ref_wall:.3f} s unarmed; megba_fleet_problems_total "
        f"{problems:.0f}, megba_fleet_batches_total {batches:.0f}, "
        f"megba_solve_lm_iterations {lm} observations; "
        f"{len(doc['traceEvents'])} trace events, {len(buckets)} "
        f"solve_bucket spans in {FLEET_TRACE.relative_to(ROOT)}; "
        f"{len(snap['metrics'])} metric families in "
        f"{FLEET_METRICS.relative_to(ROOT)}")


def fleet_queue_chaos(probs) -> None:
    """12.4: the JAX package's serving chaos smoke
    (scripts/run_tests.sh:338-470) at 64 problems, with the flight ring
    armed (MEGBA_FLIGHT): two poisoned members of the most populated
    bucket heal at rung 1, one problem of another bucket is shed, the
    first dispatch of a third bucket fails by injection
    (`DispatchChaos`) and its problems heal at rung 1, the clean results
    are bitwise the `solve_many` control's, and the ring holds the
    chaos_injection, dispatch_failure, escalation_retry and queue_shed
    events the chaos drove; then the same 64 from four submitter
    threads."""
    import threading

    from megba_tpu_torch import (EscalationPolicy, FleetQueue, ProblemOption,
                                 SolveStatus, make_nan_burst, solve_many)
    from megba_tpu_torch import observability as obs
    from megba_tpu_torch.robustness.faults import (DispatchChaos,
                                                   close_fault_window)
    from megba_tpu_torch.serving import (BucketLadder, DeadlineExceeded,
                                         FleetStats, classify)

    opt = ProblemOption()
    small = probs[:FLEET_SMALL]
    buckets = {}
    for i, p in enumerate(small):
        buckets.setdefault(classify(*p.dims(), opt.dtype, BucketLadder()),
                           []).append(i)
    big = max(buckets.values(), key=len)
    poisoned = set(big[:2])
    doomed = next(i for i in range(len(small)) if i not in set(big))
    # The smallest bucket holding neither: its first dispatch fails.
    chaos_key, chaos_members = min(
        ((k, v) for k, v in buckets.items()
         if v is not big and doomed not in v), key=lambda kv: len(kv[1]))
    injected = set(chaos_members)

    def poison(p):
        plan = make_nan_burst(p.obs.shape[0], [1, 5], start=0, stop=1,
                              n_points=p.points.shape[0], dtype=np.float64)
        return dataclasses.replace(p, fault_plan=plan)

    submitted = [poison(p) if i in poisoned else p
                 for i, p in enumerate(small)]
    stats = FleetStats()
    FLEET_FLIGHT.parent.mkdir(exist_ok=True)
    t = time.perf_counter()
    with armed_plane(FLEET_FLIGHT, knobs=("MEGBA_FLIGHT",)):
        with FleetQueue(opt, max_batch=16, max_wait_s=30.0, stats=stats,
                        escalation=EscalationPolicy(backoff_base_s=0.01,
                                                    seed=0),
                        chaos=DispatchChaos(
                            fail_first=1,
                            buckets=frozenset({str(chaos_key)})),
                        device=DEVICE) as q:
            futs = [q.submit(p, deadline_s=0.0 if i == doomed else None)
                    for i, p in enumerate(submitted)]
            q.flush()
            if not q._thread.is_alive() or not all(f.done() for f in futs):
                raise AssertionError("fleet queue: the dispatcher died or a "
                                     "future is open after flush")
            results, shed = {}, None
            for i, f in enumerate(futs):
                try:
                    results[i] = f.result(timeout=1)
                except DeadlineExceeded:
                    shed = i
        events = obs.flight_recorder().events()
    wall = time.perf_counter() - t
    if shed != doomed:
        raise AssertionError(f"fleet queue: problem {doomed} was not shed")
    # Each retry climbs one rung: the retries are the rungs the healed
    # problems ended on.
    retries = sum(results[i].rung for i in poisoned | injected)
    kinds = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    want = {"chaos_injection": 1, "dispatch_failure": 1,
            "escalation_retry": retries, "queue_shed": 1}
    if any(kinds.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"fleet queue: the flight ring holds {kinds}, "
                             f"the chaos drove {want}")
    for i in poisoned:
        r = results[i]
        if (r.status != int(SolveStatus.RECOVERED) or r.attempts != 2
                or r.rung != 1 or not np.isfinite(float(r.cost))):
            raise AssertionError(f"fleet queue: poisoned {r.name} ended "
                                 f"{r.status_name}, attempts {r.attempts}, "
                                 f"rung {r.rung}")
    for i in injected:
        r = results[i]
        if (r.rung < 1 or r.attempts != r.rung + 1
                or not np.isfinite(float(r.cost))
                or r.status == int(SolveStatus.FATAL_NONFINITE)
                or r.history[0]["error"] is None):
            raise AssertionError(f"fleet queue: injected {r.name} ended "
                                 f"{r.status_name}, attempts {r.attempts}, "
                                 f"rung {r.rung}")
    control = solve_many(
        [dataclasses.replace(p, fault_plan=close_fault_window(p.fault_plan))
         if p.fault_plan is not None else p
         for i, p in enumerate(submitted) if i != doomed], opt, device=DEVICE)
    ctrl = dict(zip([i for i in range(len(small)) if i != doomed], control))
    clean = [i for i in range(len(small))
             if i not in poisoned and i not in injected and i != doomed]
    for i in clean:
        r, c = results[i], ctrl[i]
        if (r.status != c.status or r.cameras.tobytes() != c.cameras.tobytes()
                or r.cost.tobytes() != c.cost.tobytes() or r.attempts != 1
                or r.deadline_missed):
            raise AssertionError(f"fleet queue: clean {r.name} differs from "
                                 "the closed-window control")
    d = stats.as_dict()
    if d["sheds"] != 1 or d["retries"] != retries:
        raise AssertionError(f"fleet queue: counters {d}")
    log(f"fleet queue under chaos: {len(small)} problems, max_batch 16, "
        f"{d['batches']} batches in {wall:.3f} s; poisoned "
        f"{sorted(poisoned)} RECOVERED at rung 1 (attempts 2), problem "
        f"{doomed} shed (DeadlineExceeded), bucket {chaos_key}'s first "
        f"dispatch failed by injection and its problems {sorted(injected)} "
        f"solved at rungs {[results[i].rung for i in sorted(injected)]}, "
        f"{len(clean)} clean results "
        f"bitwise the closed-window solve_many control's; retries "
        f"{d['retries']}, sheds {d['sheds']}; flight ring {kinds}")

    stats = FleetStats()
    out = [None] * len(small)
    t = time.perf_counter()
    with FleetQueue(opt, max_batch=16, max_wait_s=0.05, stats=stats,
                    device=DEVICE) as q:
        def submit(idx):
            futs = [(i, q.submit(small[i])) for i in idx]
            for i, f in futs:
                out[i] = f.result(timeout=600)

        threads = [threading.Thread(target=submit,
                                    args=(range(k, len(small), 4),))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if any(th.is_alive() for th in threads):
            raise AssertionError("fleet queue, 4 threads: a submitter hung")
        alive = q._thread.is_alive()
    wall = time.perf_counter() - t
    if (not alive or any(r is None for r in out)
            or stats.problems != len(small)):
        raise AssertionError(f"fleet queue, 4 threads: dispatcher alive "
                             f"{alive}, {stats.problems} problems solved")
    fleet_gate("fleet queue 4 threads", out)
    log(f"fleet queue, 4 submitter threads: {len(small)} futures resolved in "
        f"{wall:.3f} s over {stats.batches} batches, the dispatcher alive")


def fleet_kernel_cases(probs) -> dict:
    """12.6: kernel rows at the largest bucket's union plan (its lanes
    stacked as the batch stacks them), f32 and f64: rows "name fleet" /
    "name[f64] fleet", the camera side (2, 9) and the point side (2, 3)
    of kernels 1-3, kernel 6 over the union's cameras, kernels 4 and 5
    at the widths EXPLICIT's coupling directions take them (9 on the
    camera side, 3 on the point side), and both directions of kernels 7
    and 8 over the union's fused plans; seeded random rows as in
    `shape_cases` and `coupling_shape_cases`, the library yardsticks
    cuSPARSE CSR products for 2, 3, 7 and 8, `torch.einsum` for 6,
    `torch.segment_reduce` for 4 and `index_select` for 5 (PERF.md
    section 6's)."""
    from megba_tpu_torch.ops import fused, segtiles
    from megba_tpu_torch.serving import BucketLadder, classify, pad_to_class

    groups = {}
    for p in probs:
        groups.setdefault(classify(*p.dims(), np.float64, BucketLadder()),
                          []).append(p)
    shape, members = max(groups.items(),
                         key=lambda kv: BucketLadder().bucket_lanes(
                             len(kv[1])) * kv[0].n_edge)
    lanes = BucketLadder().bucket_lanes(len(members))
    padded = [pad_to_class(p.cameras, p.points, p.obs, p.cam_idx, p.pt_idx,
                           shape) for p in members]
    padded += [padded[0]] * (lanes - len(padded))
    ci = np.concatenate([pp.cam_idx + k * shape.n_cam
                         for k, pp in enumerate(padded)])
    pi = np.concatenate([pp.pt_idx + k * shape.n_pt
                         for k, pp in enumerate(padded)])
    _, plans = segtiles.make_dual_plans(ci, pi, lanes * shape.n_cam,
                                        lanes * shape.n_pt, DEVICE)
    for side, plan in (("cam", plans.cam), ("pt", plans.pt)):
        log(f"fleet union {shape} x {lanes} lanes, {side} side: "
            f"{plan.num_segments} segments, {plan.n_slots} slots; kernels 1 "
            f"and 3 {launch_shape(plan)}")
    cam = shape_cases(2, 9, plans.cam, "fleet_cam")
    pt = shape_cases(2, 3, plans.pt, "fleet_pt")
    cases = {}
    for name in FLEET_KERNELS[:3]:
        for suffix in ("", "[f64]"):
            cases[f"{name}{suffix} fleet"] = (cam[f"{name}(2,9){suffix}"]
                                              + pt[f"{name}(2,3){suffix}"])
    nc = lanes * shape.n_cam
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    for dtype, elt, suffix in ((torch.float32, 4, ""),
                               (torch.float64, 8, "[f64]")):
        Hrows = torch.randn((81, nc), generator=gen, device=DEVICE,
                            dtype=dtype)
        x = torch.randn((9, nc), generator=gen, device=DEVICE, dtype=dtype)
        Minv = Hrows.T.reshape(nc, 9, 9)
        cases[f"fused_block_diag_apply{suffix} fleet"] = [_case(
            "fleet_cam", (Hrows, x), (81 + 18) * nc * elt, 2 * 81 * nc,
            lambda Minv=Minv, x=x: lambda: torch.einsum("nij,jn->in", Minv,
                                                        x),
            ref64=dtype == torch.float32)]
    # Kernels 7 and 8 (both directions) through `coupling_shape_cases`,
    # its rows of 6 and of 4-5 at other widths skipped.
    skip = {f"fused_block_diag_apply(9){x}" for x in ("", "[f64]")}
    fplans = fused.with_fused_plans(plans)
    coupling = coupling_shape_cases(9, 3, 2, fplans, "fleet", skip)
    for name in ("fused_coupling_apply(9,3)",
                 "fused_coupling_apply_implicit(9,3,2)"):
        for suffix in ("", "[f64]"):
            cases[f"{name.split('(')[0]}{suffix} fleet"] = coupling[
                name + suffix]
    n = plans.cam.n_slots
    for dtype, elt, suffix in ((torch.float32, 4, ""),
                               (torch.float64, 8, "[f64]")):
        reduce_sides, expand_sides = [], []
        for side, plan, d in (("fleet_cam", plans.cam, 9),
                              ("fleet_pt", plans.pt, 3)):
            ns = plan.num_segments
            data = torch.randn((d, n), generator=gen, device=DEVICE,
                               dtype=dtype)
            lengths = (plan.seg_ptr[1:] - plan.seg_ptr[:-1]).expand(
                d, ns).contiguous()
            reduce_sides.append(_case(
                side, (data, plan), (d * n + d * ns) * elt + (ns + 1) * 8,
                d * n, lambda data=data, lengths=lengths: lambda:
                torch.segment_reduce(data, "sum", lengths=lengths, axis=1,
                                     unsafe=True),
                ref64=dtype == torch.float32))
            table = torch.randn((d, ns), generator=gen, device=DEVICE,
                                dtype=dtype)
            expand_sides.append(_case(
                side, (table, plan), (d * ns + d * n) * elt + n * 4, 0,
                lambda table=table, seg=plan.seg: lambda:
                table.index_select(1, seg)))
        cases[f"seg_reduce{suffix} fleet"] = reduce_sides
        cases[f"seg_expand{suffix} fleet"] = expand_sides
    cases.update(fleet_arm_cases(fplans, gen))
    return cases


def fleet_arm_cases(plans, gen) -> dict:
    """12.6's rows of the option paths (`FLEET_ARM_ROWS`) at the same
    union plan: kernels 2 and 3 in their mixed64 arm (bfloat16 J rows
    beside f64 tables) and bf16 arm on the camera side (2, 9) and the
    point side (2, 3); kernel 7 in its bf16 arm and 8 in its mixed arm,
    both directions; kernel 6's bf16 arm over the union's cameras; kernel
    4 on SCHUR_DIAG's correction rows (nine f64 rows over the camera
    plan, one of the nine launches a PCG solve).  Seeded random rows, the
    bytes read once and written once at each operand's own width; the
    library yardsticks as phase 3's rows of the same arms: cuSPARSE CSR
    products (bf16 values and vector for the bf16 and mixed arms, the
    bf16 rows' values in f64 for mixed64), `torch.einsum` in bfloat16
    for 6, `torch.segment_reduce` for 4."""
    from megba_tpu_torch.core.fm import coupling_rows

    bf, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    n = plans.cam.n_slots
    nc, npt = plans.cam.num_segments, plans.pt.num_segments
    i32, i64 = 4, 8

    def randn(*shape, dtype=f32, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=DEVICE,
                                   dtype=dtype)

    Jc, Jp = randn(18, n, scale=0.1).to(bf), randn(6, n, scale=0.1).to(bf)
    sides = (("fleet_cam", plans.cam, Jc, 9, nc),
             ("fleet_pt", plans.pt, Jp, 3, npt))
    mixed, bf16 = dict(bf16_operands=False), dict(bf16_operands=True)
    cases = {}
    for arm, vdt, kw in (("mixed64", f64, mixed), ("bf16", f32, bf16)):
        ve = 8 if vdt == f64 else 4
        tol = (F32_REL_TO_ABS_SUM if arm == "mixed64"
               else BF16_LIBRARY_REL_TO_ABS_SUM)
        spmv = _spmv if arm == "mixed64" else _bf16_spmv
        lt = f64 if arm == "mixed64" else bf
        expand, reduce = [], []
        for side, plan, J, d, ns in sides:
            x, u = randn(d, ns, dtype=vdt), randn(2, n, dtype=vdt)
            expand.append(_case(
                side, (x, J, plan, d),
                2 * d * n * 2 + (d * ns + 2 * n) * ve + n * i32, n * 2 * 2 * d,
                lambda J=J, x=x, plan=plan, d=d, ns=ns, spmv=spmv, lt=lt:
                spmv(_csr_expand, J.to(lt), plan.seg, d, ns, vec=x,
                     shape=(2, n)), kw, tol))
            reduce.append(_case(
                side, (J, u, plan, d),
                2 * d * n * 2 + (2 * n + d * ns) * ve + (ns + 1) * i64,
                n * 2 * 2 * d,
                lambda J=J, u=u, plan=plan, d=d, ns=ns, spmv=spmv, lt=lt:
                spmv(_csr_reduce, J.to(lt), plan.seg, d, ns, vec=u,
                     shape=(d, ns)), kw, tol))
        cases[f"coupling_expand[{arm}] fleet"] = expand
        cases[f"coupling_reduce[{arm}] fleet"] = reduce
    to_pt, to_cam = plans.fused_to_pt, plans.fused_to_cam
    x_cam, x_pt = randn(9, nc), randn(3, npt)

    def directions(rows_tp, rows_tc, row_bytes, flops, w_tp, w_tc, kw,
                   tails=((), ())):
        """cam -> pt over the point-order rows, pt -> cam over the
        camera-order rows, as `coupling_shape_cases`' directions; the
        library a bf16 CSR product of W."""
        tol = BF16_LIBRARY_REL_TO_ABS_SUM
        return [
            _case("cam_to_pt", (*rows_tp, x_cam, to_pt, *tails[0]),
                  row_bytes * n + (9 * nc + 3 * npt) * 4 + n * i32
                  + (npt + 1) * i64, n * flops,
                  lambda: _bf16_spmv(_csr_coupling, w_tp, to_pt, 9, True,
                                     vec=x_cam, shape=(3, npt)), kw, tol),
            _case("pt_to_cam", (*rows_tc, x_pt, to_cam, *tails[1]),
                  row_bytes * n + (3 * npt + 9 * nc) * 4 + n * i32
                  + (nc + 1) * i64, n * flops,
                  lambda: _bf16_spmv(_csr_coupling, w_tc, to_cam, 3, False,
                                     vec=x_pt, shape=(9, nc)), kw, tol),
        ]

    Jp_cam = plans.to_cam(Jp).contiguous()
    W = coupling_rows(Jc.to(f32), Jp_cam.to(f32), 2).contiguous()
    cases["fused_coupling_apply_implicit[bf16] fleet"] = directions(
        (plans.to_pt(Jc).contiguous(), Jp), (Jp_cam, Jc), 24 * 2, 2 * 24,
        plans.to_pt(W).contiguous().to(bf), W.to(bf), bf16)
    Wb = randn(27, n, scale=0.1).to(bf)
    Wb_tp = plans.to_pt(Wb).contiguous()
    cases["fused_coupling_apply[mixed] fleet"] = directions(
        (Wb_tp,), (Wb,), 27 * 2, 2 * 27, Wb_tp, Wb, mixed,
        ((True,), (False,)))
    Hrows = randn(81, nc)
    Minv = Hrows.T.reshape(nc, 9, 9)
    cases["fused_block_diag_apply[bf16] fleet"] = [_case(
        "fleet_cam", (Hrows.to(bf), x_cam), 81 * nc * 2 + 18 * nc * 4,
        2 * 81 * nc, lambda: lambda: torch.einsum(
            "nij,jn->in", Minv.to(bf), x_cam.to(bf)), bf16,
        BF16_LIBRARY_REL_TO_ABS_SUM)]
    plan = plans.cam
    corr = randn(9, n, dtype=f64)
    lengths = (plan.seg_ptr[1:] - plan.seg_ptr[:-1]).expand(
        9, nc).contiguous()
    cases["seg_reduce[f64] fleet schur_diag"] = [_case(
        "fleet_cam", (corr, plan), (9 * n + 9 * nc) * 8 + (nc + 1) * i64,
        9 * n, lambda: lambda: torch.segment_reduce(
            corr, "sum", lengths=lengths, axis=1, unsafe=True))]
    return cases


# Alternating turns of kernel 5's fleet row against `index_select`, by
# device time: pairs, and launches a profiled window.
EXPAND_TURN_PAIRS = 10
EXPAND_TURN_CALLS = 50


def expand_turns(rows: dict, cases: dict, name: str) -> None:
    """Kernel 5's row `name` (both sides a call) and its `index_select`
    yardstick timed by torch.profiler's device time in alternating turns
    (kernel first in even pairs, the library first in odd ones),
    `EXPAND_TURN_PAIRS` pairs of `EXPAND_TURN_CALLS` calls a window:
    medians and the pairs the kernel won go into the row
    (`turns_device_ms`, `turns_library_device_ms`, `turns_won`)."""
    kernel = getattr(kernel_module(name), base_name(name))
    sides = cases[name]
    libs = [c["library"]() for c in sides]

    def run_kernel():
        for c in sides:
            kernel(*c["args"], **c["kwargs"])

    def run_library():
        for lib in libs:
            lib()

    k_ms, l_ms = [], []
    for p in range(EXPAND_TURN_PAIRS):
        order = ((k_ms, run_kernel), (l_ms, run_library))
        for times, fn in (order if p % 2 == 0 else order[::-1]):
            times.append(device_ms_per_call(fn, EXPAND_TURN_CALLS))
    won = sum(k < lib for k, lib in zip(k_ms, l_ms))
    entry = rows[name]
    entry["turns_device_ms"] = statistics.median(k_ms)
    entry["turns_library_device_ms"] = statistics.median(l_ms)
    entry["turns_won"] = won
    log(f"kernel {name} against index_select in {EXPAND_TURN_PAIRS} "
        f"alternating pairs by device time: median "
        f"{entry['turns_device_ms'] * 1e3:.3f} us against "
        f"{entry['turns_library_device_ms'] * 1e3:.3f} us; the kernel is "
        f"faster in {won} of {EXPAND_TURN_PAIRS} pairs")


def fleet_phase(keep: dict) -> dict:
    """Phase 12: the fleet service (serving/, algo/lanes.py) on the card.
    Returns the kernel rows at the largest bucket's union, each with its
    launches from the full-size fleet run of its path (`FLEET_ROW_PATH`;
    IMPLICIT's for kernels 1-3 and 6) and arm; `keep` gets the f64
    problems, their IMPLICIT results and wall, and their results on the
    other coupling paths (phase 13's controls)."""
    t0 = time.perf_counter()
    probs64 = fleet_problems(FLEET_N, np.float64)
    probs32 = fleet_problems(FLEET_N, np.float32)
    probs = {64: probs64, 32: probs32}
    launches = {}
    ref64, launches[64, "implicit"], ref_records, ref_wall = fleet_full(
        probs64, np.float64)
    keep.update(probs=probs64, results=ref64, wall=ref_wall)
    steps = [time.perf_counter()]
    ref32, launches[32, "implicit"], _, ref32_wall = fleet_full(
        probs32, np.float32)
    steps.append(time.perf_counter())
    for path in list(FLEET_PATHS)[1:]:
        # The one f64 run of each other coupling path is its profiled one
        # (a depth cut: PERF.md section 4).
        res64, launches[64, path] = fleet_full(probs64, np.float64,
                                               path, once=True)[:2]
        keep[path] = res64
        launches[32, path] = fleet_full(probs32[:FLEET_F32_RERUN],
                                        np.float32, path, profile=False)[1]
    steps.append(time.perf_counter())
    refs = {64: (ref64, ref_wall), 32: (ref32, ref32_wall)}
    for path, (_, _, dtype, _, _) in FLEET_OPTION_PATHS.items():
        bits = np.dtype(dtype).itemsize * 8
        res, launches[bits, path], _, wall = fleet_full(
            probs[bits][:FLEET_OPTION_N], dtype, path, once=True)
        ref = refs[bits][0][:FLEET_OPTION_N]
        log(f"fleet {path} {np.dtype(dtype).name} at most "
            f"{FLEET_OPTION_LM} LM a problem against IMPLICIT's at "
            f"{np.dtype(dtype).name} under ProblemOption()'s LM cap on the "
            f"first {FLEET_OPTION_N} problems (different depths): LM "
            f"iterations {sum(r.iterations for r in res)} "
            f"against {sum(r.iterations for r in ref)}, PCG "
            f"{sum(r.pcg_iterations for r in res)} against "
            f"{sum(r.pcg_iterations for r in ref)}, wall {wall:.3f} s "
            "(its profiled buckets' profiler start, stop and event "
            "reading taken out)")
    steps.append(time.perf_counter())
    fleet_armed(probs64, ref64, ref_records, ref_wall)
    steps.append(time.perf_counter())
    fleet_serial(probs64)
    steps.append(time.perf_counter())
    for path in FLEET_PATHS:
        fleet_kernels_vs_plain(probs64, path)
    for path, (_, _, dtype, _, _) in FLEET_OPTION_PATHS.items():
        fleet_kernels_vs_plain(probs[np.dtype(dtype).itemsize * 8], path)
    steps.append(time.perf_counter())
    fleet_queue_chaos(probs64)
    steps.append(time.perf_counter())
    cases = fleet_kernel_cases(probs64)
    rows = measure_rows(cases)
    row_device_times(rows, cases, list(rows))
    for suffix in ("", "[f64]"):
        expand_turns(rows, cases, f"seg_expand{suffix} fleet")
    for name, row in rows.items():
        if name in FLEET_ARM_ROWS:
            path, key = FLEET_ARM_ROWS[name]
            bits = np.dtype(FLEET_OPTION_PATHS[path][2]).itemsize * 8
            row["launches"] = launches[bits, path].get(key)
            continue
        path = FLEET_ROW_PATH.get(base_name(name), "implicit")
        arm = 64 if "[f64]" in name else 32
        row["launches"] = launches[arm, path].get(base_name(name))
    steps.append(time.perf_counter())
    log(f"fleet phase: {steps[-1] - t0:.1f} s (full fleet f64, f32, the "
        "EXPLICIT and fused paths f64 and f32, the option paths, armed, "
        "serial vs batched, kernels vs plain on eleven paths, queue, kernel "
        "rows: "
        + ", ".join(f"{b - a:.1f}" for a, b in zip([t0] + steps, steps))
        + " s)")
    return rows


# ---------------------------------------------------------------------------
# Phase 13: the federation tier
# ---------------------------------------------------------------------------

FED_WORKERS = 2
# Router batches of up to a whole bucket (the fleet's largest holds 512
# problems): the dispatched (bucket, lanes) keys are the manifest's.
FED_MAX_BATCH = 512
FED_KILL = 256  # problems of the host-loss run
FED_TCP = 64  # problems of the TCP runs (fused EXPLICIT f64)
FED_TCP_MAX_BATCH = 16
# Seeded faults per forwarded chunk: this seed drops the first chunk of
# connection 0 and truncates that of connection 1 (each the register
# frame of a worker: one drop and one truncate whatever the timing), and
# draws more at random from there on.
FED_CHAOS = dict(seed=21577, drop_rate=0.005, truncate_rate=0.005)


def fed_bitwise(what: str, results, control) -> None:
    """Each federated result bitwise its control's: cameras, points,
    cost, status and counts."""
    if len(results) != len(control):
        raise AssertionError(f"{what}: {len(results)} results for "
                             f"{len(control)} problems")
    for r, c in zip(results, control):
        same = (r.name == c.name
                and r.cameras.tobytes() == c.cameras.tobytes()
                and r.points.tobytes() == c.points.tobytes()
                and np.asarray(r.cost).tobytes()
                == np.asarray(c.cost).tobytes()
                and (int(r.status), r.iterations, r.accepted,
                     r.pcg_iterations)
                == (int(c.status), c.iterations, c.accepted,
                    c.pcg_iterations))
        if not same:
            raise AssertionError(f"{what}: {r.name} is not bitwise its "
                                 f"control ({c.name}): cost {r.cost} "
                                 f"against {c.cost}")


def fed_worker_stats(router) -> dict:
    """Each live worker's stats reply (problems solved, phases, kernel
    launches of its process), pulled over the RPC."""
    return {wid: w.request({"op": "stats"}, timeout_s=120.0)
            for wid, w in router.workers.items() if w.alive}


def fed_launches(stats: dict) -> dict:
    out = {}
    for reply in stats.values():
        for k, v in reply["launches"].items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def fed_check_launches(what: str, launches: dict, names) -> None:
    missing = [n for n in names if not launches.get(n)]
    if missing:
        raise AssertionError(f"{what}: the workers never launched "
                             f"{missing} (launches {launches})")


def federation_phase(kept: dict, build_s: float, smi: str) -> None:
    """Phase 13: the federation tier on the card (module docstring)."""
    import shutil
    import signal
    import socket
    import tempfile
    import threading

    from megba_tpu_torch.ops import kernels
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn
    from megba_tpu_torch.robustness.netfaults import (ChaosTcpProxy,
                                                      NetFaultPlan)
    from megba_tpu_torch.serving import (ArtifactStore, BucketLadder,
                                         CompilePool, FleetRouter,
                                         FleetStats)
    from megba_tpu_torch.serving.batcher import _group_by_bucket

    t0 = time.perf_counter()
    probs, control, control_wall = (kept["probs"], kept["results"],
                                    kept["wall"])
    opt = fleet_option(np.float64)
    tmp = Path(tempfile.mkdtemp(prefix="megba_fed_"))
    try:
        # 13.1: export from the parent's pool; workers of a fresh copy.
        ladder = BucketLadder()
        entries = [{"shape": sc.to_dict(),
                    "lanes": ladder.bucket_lanes(len(items)),
                    "cd": dims[0], "pd": dims[1], "od": dims[2],
                    "factor": factor}
                   for (sc, dims, factor), items in _group_by_bucket(
                       probs, opt, ladder).items()]
        engine = make_residual_jacobian_fn(mode=opt.jacobian_mode)
        store = ArtifactStore(str(tmp / "store"))
        pool = CompilePool(stats=FleetStats(), artifacts=store)
        t = time.perf_counter()
        pool.warm(engine, opt, entries, device=DEVICE)
        written = pool.export_artifacts(engine, opt, device=DEVICE)
        manifest = tmp / "manifest.json"
        pool.save_manifest(str(manifest), option=opt)
        size = sum(p.stat().st_size for p in Path(store.root).iterdir())
        log(f"federation: exported {written} artifacts ({size / 2**20:.1f} "
            f"MiB, {len(entries)} buckets) and the manifest in "
            f"{time.perf_counter() - t:.2f} s")
        if written != len(entries):
            raise AssertionError(f"federation: {written} artifacts for "
                                 f"{len(entries)} buckets")
        copy = tmp / "pkg"
        shutil.copytree(ROOT / "megba_tpu_torch", copy / "megba_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        if (copy / "build").exists():
            raise AssertionError("federation: the copy has a build/")
        t = time.perf_counter()
        router = FleetRouter(opt, n_workers=FED_WORKERS,
                             max_batch=FED_MAX_BATCH, artifacts=store.root,
                             manifest=str(manifest), strict_manifest=True,
                             worker_env={"PYTHONPATH": str(copy)})
        up_s = time.perf_counter() - t
        try:
            cold = router.stats.as_dict()["cold_start"]
            for wid, cs in sorted(cold.items()):
                if not (cs["mode"] == "artifact"
                        and cs["artifact_compiles"] == 0
                        and cs["artifact_loads"] == len(entries)
                        and cs["nvcc_builds"] == 0
                        and cs["package"].startswith(str(copy))):
                    raise AssertionError(f"federation: worker {wid} did not "
                                         f"start cold from artifacts: {cs}")
                log(f"federation: worker {wid} cold start from artifacts "
                    f"{cs['warm_s']:.3f} s ({cs['artifact_loads']} loaded / "
                    f"{cs['artifact_compiles']} compiled, "
                    f"{cs['nvcc_builds']} nvcc builds; package "
                    f"{cs['package']}) against the parent's build "
                    f"{build_s:.1f} s; {smi}")
            log(f"federation: {FED_WORKERS} pipe workers up in {up_s:.1f} s "
                "(interpreter, torch, CUDA context, artifact warm-up)")

            # 13.2: the whole fleet through the router, bitwise phase 12.
            t = time.perf_counter()
            futs = router.submit_many(probs)
            router.flush()
            wall = time.perf_counter() - t
            results = [f.result(timeout=0) for f in futs]
            fed_bitwise("federation fleet", results, control)
            d = router.stats.as_dict()
            if sum(d["problems_by_worker"].values()) != len(probs):
                raise AssertionError(f"federation: problems by worker "
                                     f"{d['problems_by_worker']}")
            for wid, fs in d["first_solve"].items():
                if fs["traces"] != 0:
                    raise AssertionError(f"federation: worker {wid}'s first "
                                         f"solve ran nvcc: {fs}")
            launches = fed_launches(fed_worker_stats(router))
            fed_check_launches("federation fleet", launches, FLEET_KERNELS)
            log(f"federation fleet: {len(probs)} problems bitwise phase 12's "
                f"IMPLICIT f64 results, wall {wall:.3f} s "
                f"({len(probs) / wall:.1f} problems/s) against solve_many's "
                f"{control_wall:.3f} s ({len(probs) / control_wall:.1f} "
                f"problems/s; {wall / control_wall:.2f}x; the workers' first "
                f"solves included), {d['steals']} steals "
                f"({d['stolen_problems']} problems), by worker "
                f"{d['problems_by_worker']}, first solves {d['first_solve']};"
                f" workers' launches {launches}; {smi}")
            # Again, each worker past its first solve (its first use of
            # the kernels and of PyTorch's allocator in that process).
            t = time.perf_counter()
            futs = router.submit_many(probs)
            router.flush()
            warm_wall = time.perf_counter() - t
            fed_bitwise("federation fleet again",
                        [f.result(timeout=0) for f in futs], control)
            d2 = router.stats.as_dict()
            log(f"federation fleet again: bitwise, wall {warm_wall:.3f} s "
                f"({len(probs) / warm_wall:.1f} problems/s; "
                f"{warm_wall / control_wall:.2f}x solve_many's), "
                f"{d2['steals'] - d['steals']} steals, by worker "
                f"{d2['problems_by_worker']}; {smi}")

            # 13.3: host loss: SIGKILL a worker at its second request.
            kill_probs, kill_control = probs[:FED_KILL], control[:FED_KILL]
            before = router.stats.as_dict()
            state = {"replied": set(), "victim": None}
            lock = threading.Lock()
            for w in list(router.workers.values()):
                inner = w.request

                def request(msg, timeout_s=None, w=w, inner=inner):
                    solve = msg.get("op") == "solve"
                    with lock:
                        kill = (solve and state["victim"] is None
                                and w.worker_id in state["replied"])
                        if kill:
                            state["victim"] = w.worker_id
                    if kill:
                        w.proc.send_signal(signal.SIGKILL)
                        w.proc.wait(timeout=60)
                    reply = inner(msg, timeout_s)
                    if solve:
                        with lock:
                            state["replied"].add(w.worker_id)
                    return reply

                w.request = request
            t = time.perf_counter()
            futs = router.submit_many(kill_probs)
            router.flush()
            wall = time.perf_counter() - t
            pending = [f for f in futs if not f.done()]
            if pending:
                raise AssertionError(f"federation: {len(pending)} futures "
                                     "pending after flush")
            fed_bitwise("federation host loss",
                        [f.result(timeout=0) for f in futs], kill_control)
            d = router.stats.as_dict()
            rerouted = d["reroutes"] - before["reroutes"]
            if not (state["victim"] is not None and d["workers_lost"] == 1
                    and rerouted >= 1):
                raise AssertionError(
                    f"federation: host loss victim {state['victim']}, "
                    f"workers lost {d['workers_lost']}, rerouted "
                    f"{rerouted}")
            log(f"federation host loss: {FED_KILL} problems, worker "
                f"{state['victim']} SIGKILLed after its first reply: "
                f"{d['workers_lost']} lost, {rerouted} problems rerouted, "
                f"bitwise, no future pending; wall {wall:.3f} s; by worker "
                f"{d['problems_by_worker']}; {smi}")
        finally:
            router.close()

        # 13.4: TCP workers behind the chaos proxy, fused EXPLICIT f64;
        # the control is phase 12's fused EXPLICIT run of the fleet.
        tcp_probs = probs[:FED_TCP]
        topt = fleet_option(np.float64, "fused_explicit")
        tcontrol = kept["fused_explicit"][:FED_TCP]
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        with ChaosTcpProxy(f"127.0.0.1:{port}",
                           NetFaultPlan(**FED_CHAOS)) as proxy:
            t = time.perf_counter()
            router = FleetRouter(topt, n_workers=FED_WORKERS,
                                 max_batch=FED_TCP_MAX_BATCH,
                                 transport="tcp", bind=f"127.0.0.1:{port}",
                                 advertise=proxy.address,
                                 token="chip-smoke")
            up_s = time.perf_counter() - t
            try:
                counts = router.timer.counts
                solved = 0
                for run in ("seeded faults", "clean"):
                    if run == "clean":
                        # New connections take the clean plan: sever the
                        # live ones and wait for both workers to re-dial.
                        epochs = {w.worker_id: w._epoch
                                  for w in router.workers.values()}
                        proxy.plan = NetFaultPlan()
                        proxy.partition()
                        proxy.heal()
                        deadline = time.perf_counter() + 60
                        while any(w._epoch <= epochs[w.worker_id]
                                  for w in router.workers.values()):
                            if time.perf_counter() > deadline:
                                raise AssertionError(
                                    "federation: TCP workers did not "
                                    "re-register after the partition")
                            time.sleep(0.05)
                    ev0 = {k: counts.get(f"transport_{k}", 0) for k in
                           ("conn_lost", "resend", "reconnect")}
                    t = time.perf_counter()
                    futs = router.submit_many(tcp_probs)
                    router.flush()
                    wall = time.perf_counter() - t
                    fed_bitwise(f"federation tcp {run}",
                                [f.result(timeout=0) for f in futs],
                                tcontrol)
                    stats = fed_worker_stats(router)
                    n = sum(r["stats"]["problems"] for r in stats.values())
                    dedup = sum(r["phases"].get("transport_dedup_hit",
                                                {}).get("calls", 0)
                                for r in stats.values())
                    ev = {k: counts.get(f"transport_{k}", 0) - v
                          for k, v in ev0.items()}
                    if n - solved != len(tcp_probs):
                        raise AssertionError(
                            f"federation tcp {run}: {n - solved} problems "
                            f"solved for {len(tcp_probs)}")
                    solved = n
                    launches = fed_launches(stats)
                    fed_check_launches(f"federation tcp {run}", launches,
                                       ("jtj_grad_reduce",
                                        "fused_coupling_apply",
                                        "fused_block_diag_apply"))
                    events = proxy.event_counts()
                    if run == "clean" and (ev["conn_lost"] or ev["resend"]):
                        raise AssertionError(
                            f"federation tcp clean: connections lost or "
                            f"resent {ev}")
                    if run != "clean" and not (events.get("drop")
                                               and events.get("truncate")):
                        raise AssertionError(
                            f"federation tcp: proxy events {events}")
                    log(f"federation tcp {run}: {len(tcp_probs)} problems "
                        f"fused EXPLICIT f64 bitwise phase 12's, each "
                        f"solved once; wall {wall:.3f} s; "
                        f"proxy events so far {events}; router {ev}; dedup "
                        f"hits so far {dedup}; workers up in {up_s:.1f} s; "
                        f"workers' launches {launches}; {smi}")
            finally:
                router.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"federation phase: {time.perf_counter() - t0:.1f} s; {smi}")


# ---------------------------------------------------------------------------
# Phase 14: the host tools
# ---------------------------------------------------------------------------

# The BAL CLIs (megba_tpu_torch/examples/): their dtype, Jacobian mode,
# compute kind (examples/README.md's table) and the phase-7 path whose
# launches they must make; one of them also runs as a real subprocess.
HOST_CLIS = {
    "BAL_Double": (np.float64, "AUTODIFF", "EXPLICIT", "explicit"),
    "BAL_Float": (np.float32, "AUTODIFF", "EXPLICIT", "explicit"),
    "BAL_Double_analytical": (np.float64, "ANALYTICAL", "EXPLICIT",
                              "explicit"),
    "BAL_Float_analytical": (np.float32, "ANALYTICAL", "EXPLICIT",
                             "explicit"),
    "BAL_Double_implicit": (np.float64, "AUTODIFF", "IMPLICIT", "implicit"),
    "BAL_Double_analytical_implicit": (np.float64, "ANALYTICAL", "IMPLICIT",
                                       "implicit"),
}
HOST_CLI_SUBPROCESS = "BAL_Double_implicit"
HOST_CLI_ARGS = ("--max_iter", "2")  # cut from 3 for the time limit
PLANAR_ARGS = ()  # planar_demo.py at its defaults
# The chunked venice run's re-lowering before the plan cache (PERF.md
# section 5: phase 11 on an NVIDIA H100 80GB HBM3 at 700.00 W).
RELOWERING_BEFORE_S = 4.659
# Kernels 1-3 by the names of their CUDA kernels in a profiler trace:
# the reductions' row functors (csrc/segtiles.cu) and kernel 2's kernel.
TRACE_KERNELS = {"jtj_grad_reduce": "JtjRows",
                 "coupling_expand": "expand_matvec",
                 "coupling_reduce": "JtuRows"}
_FINAL_COST = "final cost: "


def plan_cache_words(before: dict) -> str:
    """The plan cache's hits, misses and evictions since `before`
    (`segtiles.plan_cache_counts()`), for the log."""
    from megba_tpu_torch.ops import segtiles

    now = segtiles.plan_cache_counts()
    return ", ".join(f"{now[k] - before[k]} {k}" for k in now)


def relowering_of(chunks) -> list:
    """Each chunk's re-lowering seconds (the timer's "lowering", "sort",
    "plan" and "coarse_plan") and whether its plans were a cache hit."""
    out = []
    for c in chunks:
        tot = c["timer"].totals
        out.append((sum(tot.get(k, 0.0) for k in
                        ("lowering", "sort", "plan", "coarse_plan")),
                    tot.get("lowering", 0.0), tot.get("plan", 0.0),
                    bool(c["timer"].counts.get("plan_cache_hit"))))
    return out


class NumpyParse:
    """The NumPy tokenizer's parse of a BAL file (`np.fromfile`, which
    releases the interpreter lock, then `io.bal._assemble`) on a thread of
    its own, so that it overlaps the CLIs' runs; `join()` returns (the
    float64 BALFile, its seconds)."""

    def __init__(self, path: Path) -> None:
        import threading

        self.out = {}
        self.thread = threading.Thread(target=self._run, args=(path,))
        self.thread.start()

    def _run(self, path: Path) -> None:
        from megba_tpu_torch.io import bal as tbal

        try:
            t = time.perf_counter()
            with open(path, "rb") as f:
                tokens = np.fromfile(f, sep=" ")
            self.out["bal"] = tbal._assemble(tokens, np.float64,
                                             where=str(path))
            self.out["seconds"] = time.perf_counter() - t
        except Exception as e:  # re-raised by join()
            self.out["error"] = e

    def join(self) -> tuple:
        self.thread.join()
        if "error" in self.out:
            raise self.out["error"]
        return self.out["bal"], self.out["seconds"]


def host_native(venice, tmp: Path) -> tuple:
    """14.1: the native library (built or loaded: required) and the venice
    scene written once with `save_bal` and parsed natively; the NumPy
    tokenizer's parse of the same file is started on a thread
    (`NumpyParse`).  Returns (path, the native float64 BALFile, its
    seconds, the NumpyParse)."""
    from megba_tpu_torch import native
    from megba_tpu_torch.io import bal as tbal

    t = time.perf_counter()
    if not native.available():
        raise AssertionError("native: the host library did not build or "
                             f"load ({native.BUILD_INFO})")
    info = native.BUILD_INFO
    how = (f"built by g++ in {info['seconds']:.3f} s" if info["built"]
           else "loaded (built earlier in this checkout)")
    log(f"native: {info['path']} {how}, ready "
        f"{time.perf_counter() - t:.3f} s after the first call")
    path = tmp / "venice.txt"
    bal = tbal.BALFile(cameras=venice.cameras0, points=venice.points0,
                       obs=venice.obs, cam_idx=venice.cam_idx,
                       pt_idx=venice.pt_idx)
    t = time.perf_counter()
    tbal.save_bal(path, bal)
    log(f"native: venice written by save_bal, {path.stat().st_size} bytes "
        f"in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    nat = native.parse_bal_native(str(path))
    nat_s = time.perf_counter() - t
    if not np.array_equal(nat.obs, venice.obs.astype(np.float64)):
        raise AssertionError("native: the file does not hold the scene")
    return path, nat, nat_s, NumpyParse(path)


def check_numpy_parse(nat, nat_s: float, parse: NumpyParse) -> None:
    """14.1, its end: the NumPy tokenizer's five arrays equal the native
    parser's (so every CLI's reference solve, which ran on the native
    arrays, ran on the NumPy-parsed ones)."""
    ref, np_s = parse.join()
    for f in ("cameras", "points", "obs", "cam_idx", "pt_idx"):
        a, b = getattr(nat, f), getattr(ref, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"native: the parsed {f} differ from the "
                                 "NumPy tokenizer's")
    log(f"native: venice parsed natively in {nat_s:.3f} s, by the NumPy "
        f"tokenizer in {np_s:.3f} s ({np_s / nat_s:.1f}x; on a thread, "
        "beside the rest of the phase), all five arrays equal")


def host_cli_reference(name: str, ref, argv) -> tuple:
    """The in-process `flat_solve` a CLI must match: the parsed arrays in
    the CLI's dtype, its options and engine, on the card; (result, launch
    counts, wall)."""
    from megba_tpu_torch import flat_solve
    from megba_tpu_torch.common import ComputeKind, JacobianMode
    from megba_tpu_torch.examples.common import (build_arg_parser,
                                                 example_option)
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn

    dtype, jm, ck, _ = HOST_CLIS[name]
    opt = example_option(dtype, JacobianMode[jm], ComputeKind[ck],
                         build_arg_parser().parse_args(argv))
    arrays = [a.astype(dtype) if a.dtype.kind == "f" else a
              for a in (ref.cameras, ref.points, ref.obs, ref.cam_idx,
                        ref.pt_idx)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    res = flat_solve(make_residual_jacobian_fn(mode=JacobianMode[jm]),
                     *arrays, opt, device=DEVICE)
    torch.cuda.synchronize()
    return res, launch_counts(), time.perf_counter() - t


def run_cli(module: str, argv) -> tuple:
    """`main(argv)` of a CLI of megba_tpu_torch/examples in-process, its
    output kept from the log: (final cost, launch counts, wall, the
    output's last lines)."""
    import importlib
    import io

    mod = importlib.import_module(f"megba_tpu_torch.examples.{module}")
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cost = mod.main(argv=list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    tail = [ln for ln in out.getvalue().splitlines()
            if ln.startswith(("Finished", "planar BA"))]
    return cost, launch_counts(), wall, tail


def same_cost(what: str, cost: float, res) -> None:
    """A CLI's final cost bitwise its in-process solve's, finite and
    below the initial."""
    if np.float64(cost).tobytes() != np.float64(float(res.cost)).tobytes():
        raise AssertionError(f"{what}: final cost {cost!r} is not bitwise "
                             f"the in-process solve's {float(res.cost)!r}")
    if not (np.isfinite(cost) and cost < float(res.initial_cost)):
        raise AssertionError(f"{what}: final cost {cost} not below the "
                             f"initial {float(res.initial_cost)}")


def host_clis(path: Path, ref) -> None:
    """14.2: the six BAL CLIs on the venice file and planar_demo.py at its
    defaults, each bitwise its in-process `flat_solve` with launches as
    the phase-7 path implies; `HOST_CLI_SUBPROCESS` again as a real
    subprocess, started first so that its start-up overlaps the
    in-process runs (the card is shared meanwhile: walls, not results,
    feel it)."""
    import os

    argv = ("--path", str(path)) + HOST_CLI_ARGS
    t_sub = time.perf_counter()
    sub = subprocess.Popen(
        [sys.executable,
         str(ROOT / "megba_tpu_torch" / "examples"
             / f"{HOST_CLI_SUBPROCESS}.py"), *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        costs = {}
        for name, (_, _, _, path_kind) in HOST_CLIS.items():
            cost, counts, wall, tail = run_cli(name, argv)
            res, ref_counts, ref_wall = host_cli_reference(name, ref, argv)
            want = expected_launches(path_kind, res)
            if counts != ref_counts or counts != want:
                raise AssertionError(
                    f"CLI {name}: launches {counts}; the in-process "
                    f"solve's {ref_counts}, the code implies {want}")
            missing = [k for k in PATHS[path_kind][3] if not counts[k]]
            if missing:
                raise AssertionError(f"CLI {name}: never launched "
                                     f"{missing}")
            same_cost(f"CLI {name}", cost, res)
            costs[name] = cost
            log(f"CLI {name}: {tail[-1] if tail else ''}; wall {wall:.3f} "
                f"s (load_bal included; the in-process flat_solve "
                f"{ref_wall:.3f} s), final cost bitwise the in-process "
                f"solve's; launches "
                f"{ {k: v for k, v in counts.items() if v} } as "
                f"PATHS['{path_kind}'] implies")
        host_planar()
        out, err = sub.communicate(timeout=600)
    finally:
        if sub.poll() is None:
            sub.kill()
            sub.wait()
    sub_wall = time.perf_counter() - t_sub
    if sub.returncode != 0:
        raise AssertionError(f"CLI {HOST_CLI_SUBPROCESS} subprocess: rc "
                             f"{sub.returncode}\n{err[-3000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith(_FINAL_COST)]
    done = [ln for ln in out.splitlines() if ln.startswith("Finished")]
    want = costs[HOST_CLI_SUBPROCESS]
    if len(lines) != 1 or float(lines[0][len(_FINAL_COST):]) != want:
        raise AssertionError(f"CLI {HOST_CLI_SUBPROCESS} subprocess: "
                             f"{lines} against {want!r}")
    log(f"CLI {HOST_CLI_SUBPROCESS} as a subprocess (OMP_NUM_THREADS=1, "
        f"beside the in-process runs): {sub_wall:.3f} s from its start to "
        f"its exit (interpreter, torch, CUDA context, kernel libraries "
        f"loaded from build/, the engine's first use, parse and solve); "
        f"{done[-1] if done else ''}; final cost bitwise the in-process "
        "run's")


def host_planar() -> None:
    """planar_demo.py at its defaults (`PLANAR_ARGS`), bitwise its
    in-process `flat_solve`, launches as the IMPLICIT path implies."""
    from megba_tpu_torch import flat_solve
    from megba_tpu_torch.common import JacobianMode
    from megba_tpu_torch.examples.planar_demo import planar_option
    from megba_tpu_torch.models import planar
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn

    cost, counts, wall, tail = run_cli("planar_demo", PLANAR_ARGS)
    s = planar.make_synthetic_planar(num_cameras=12, num_points=200,
                                     obs_per_point=5, noise=0.2,
                                     param_noise=3e-2, seed=0)
    torch.cuda.synchronize()
    reset_launch_counts()
    engine = make_residual_jacobian_fn(residual_fn=planar.residual,
                                       mode=JacobianMode.AUTODIFF)
    res = flat_solve(engine, s.cameras0, s.points0, s.obs, s.cam_idx,
                     s.pt_idx, planar_option(20), device=DEVICE)
    torch.cuda.synchronize()
    ref_counts = launch_counts()
    want = expected_launches("implicit", res, dims=(4, 2))
    if counts != ref_counts or counts != want:
        raise AssertionError(f"planar_demo: launches {counts}; the "
                             f"in-process solve's {ref_counts}, the code "
                             f"implies {want}")
    same_cost("planar_demo", cost, res)
    log(f"CLI planar_demo (defaults): {tail[-1] if tail else ''}; wall "
        f"{wall:.3f} s, final cost bitwise the in-process solve's; launches "
        f"{ {k: v for k, v in counts.items() if v} } as PATHS['implicit'] "
        "implies (kernels 1-3 at (1, 4) and (1, 2))")


def cold_warm(what: str, arrays, opt, kw: dict, event: str) -> None:
    """One solve on a cleared plan cache and one more on the warm cache:
    the second counts `event` and is bitwise the first (trace, cameras,
    points); the "plan" and "coarse_plan" seconds of both are logged."""
    from megba_tpu_torch import flat_solve
    from megba_tpu_torch.ops import segtiles
    from megba_tpu_torch.utils.timing import PhaseTimer

    segtiles.clear_plan_cache()
    runs = []
    for _ in range(2):
        timer = PhaseTimer()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = flat_solve(None, *arrays, opt, device=DEVICE, timer=timer, **kw)
        torch.cuda.synchronize()
        runs.append((res, timer, time.perf_counter() - t))
    (a, ta, wa), (b, tb, wb) = runs
    if ta.counts.get(event) or tb.counts.get(event) != 1:
        raise AssertionError(f"{what}: {event} cold {ta.counts.get(event)}, "
                             f"warm {tb.counts.get(event)}")
    k = a.iterations
    same = (torch.equal(a.trace.cost[:k], b.trace.cost[:k])
            and torch.equal(a.cameras, b.cameras)
            and torch.equal(a.points, b.points)
            and (a.iterations, a.accepted, a.pcg_iterations)
            == (b.iterations, b.accepted, b.pcg_iterations))
    if not same:
        raise AssertionError(f"{what}: the warm run is not bitwise the cold "
                             "one")
    coarse = ""
    if a.coarse_plan_seconds is not None:
        coarse = (f"; coarse_plan_seconds {a.coarse_plan_seconds:.4f} s "
                  f"(miss) against {b.coarse_plan_seconds:.4f} s (hit)")
    log(f"plan cache {what}: plan phase {ta.totals['plan']:.4f} s cold, "
        f"{tb.totals['plan']:.4f} s warm; coarse_plan phase "
        f"{ta.totals.get('coarse_plan', 0.0):.4f} / "
        f"{tb.totals.get('coarse_plan', 0.0):.4f} s{coarse}; flat_solve "
        f"{wa:.3f} s cold, {wb:.3f} s warm; warm {event} 1, bitwise the "
        f"cold run (trace, cameras, points); the cache holds "
        f"{len(segtiles._PLAN_CACHE)} entries, "
        f"{segtiles.plan_cache_device_bytes() / 2**20:.1f} MiB on the card")


def host_trace_profile(scene) -> None:
    """14.4: one trafalgar-sized solve under `utils.timing.trace_profile`
    into a temporary directory: its trace names kernels 1-3 and the
    PhaseTimer ranges."""
    import tempfile

    from megba_tpu_torch import flat_solve
    from megba_tpu_torch.utils.timing import PhaseTimer, trace_profile

    opt = solve_option(np.float32, "implicit", lm=VENICE_LM)
    arrays, kw = solve_inputs(scene, "implicit")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        with trace_profile(tmp):
            flat_solve(None, *arrays, opt, device=DEVICE, timer=PhaseTimer(),
                       **kw)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        files = list(Path(tmp).glob("trace-*.json"))
        if len(files) != 1:
            raise AssertionError(f"trace_profile: {files}")
        size = files[0].stat().st_size
        names = {e.get("name", "") for e in json.loads(
            files[0].read_text())["traceEvents"]}
    found = {k: sum(v in n for n in names) for k, v in TRACE_KERNELS.items()}
    phases = sorted(n for n in names if n.startswith("megba.phase."))
    if not all(found.values()) or "megba.phase.dispatch" not in phases:
        raise AssertionError(f"trace_profile: kernels {found}, phase "
                             f"ranges {phases}")
    log(f"trace_profile: a trafalgar-sized f32 solve, {wall:.3f} s with the "
        f"trace written ({size} bytes); kernel names {found}, PhaseTimer "
        f"ranges {phases}")


def host_tools_phase(venice, locality, trafalgar, chunked, smi: str) -> None:
    """Phase 14: the host tools on the card (module docstring).  The NumPy
    tokenizer's parse runs on a thread from the file's write to the
    phase's end, beside the CLIs, the plan-cache runs and the profiled
    solve."""
    import tempfile

    t0 = time.perf_counter()
    steps = [t0]
    with tempfile.TemporaryDirectory() as tmp:
        path, nat, nat_s, parse = host_native(venice, Path(tmp))
        steps.append(time.perf_counter())
        try:
            host_clis(path, nat)
            steps.append(time.perf_counter())
            arrays, kw = solve_inputs(venice, "implicit", venice=True)
            cold_warm("venice implicit f32", arrays,
                      solve_option(np.float32, "implicit", lm=VENICE_LM),
                      kw, "plan_cache_hit")
            arrays, kw = solve_inputs(locality, "implicit_two_level",
                                      venice=True)
            cold_warm("locality two_level f32", arrays,
                      solve_option(np.float32, "implicit_two_level",
                                   lm=LOCALITY_LM), kw,
                      "cluster_plan_cache_hit")
            steps.append(time.perf_counter())
            host_trace_profile(trafalgar)
            steps.append(time.perf_counter())
        finally:
            parse.thread.join()
        check_numpy_parse(nat, nat_s, parse)
        steps.append(time.perf_counter())
    parts = ", ".join(
        f"chunk {i} {tot:.3f} s (lowering {low:.3f}, plan {plan:.3f}; "
        f"{'hit' if hit else 'miss'})"
        for i, (tot, low, plan, hit) in enumerate(chunked))
    log(f"plan cache: phase 11's chunked venice re-lowering "
        f"{sum(c[0] for c in chunked):.3f} s in all ({parts}) against "
        f"{RELOWERING_BEFORE_S} s before the cache (PERF.md section 5)")
    log(f"host tools phase: {steps[-1] - t0:.1f} s (native and file, CLIs, "
        "plan cache, trace_profile, the rest of the NumPy parse: "
        + ", ".join(f"{b - a:.1f}" for a, b in zip(steps, steps[1:]))
        + f" s; the NumPy parse, on a thread, and the subprocess CLI "
        f"overlap the rest); {smi}")


# ---------------------------------------------------------------------------
# Phase 15: the multi-process runtime
# ---------------------------------------------------------------------------

# Where the ranks read their problems and write their results (build/ is
# git-ignored; the directory is emptied first).
MP_DIR = ROOT / "build" / "chip_smoke_mp"
MP_WORLD = 2
MP_RANK_TIMEOUT_S = 240
# Phase 7's one-process world-2 venice run and phase 10's world-2 graph,
# kept for 15.1 and 15.2 (venice_phase and pgo_f64_paths fill it).
MP_KEPT: dict = {}
ELASTIC_LM = F64_LM
ELASTIC = dict(interval_s=0.1, straggler_after_s=0.6, dead_after_s=1.5,
               watchdog_s=60.0, compile_grace_s=120.0, poll_s=0.05)


def mp_env() -> dict:
    """The environment of phase 15's processes: this checkout's package
    first on the path (`python -P` leaves the script's directory out)."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def mp_rank_device() -> str:
    """The one device each rank solves on: the card's first (every rank
    shares it), or the CPU on a dry run."""
    return "cpu" if DEVICE.type == "cpu" else "cuda:0"


def mp_rendezvous():
    """Start the rendezvous process on a free port; (process, port)."""
    import selectors

    proc = subprocess.Popen(
        [sys.executable, "-P", "-m", "megba_tpu_torch.parallel.multihost",
         "--serve", "0", str(MP_WORLD)], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=mp_env())
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    if not sel.select(timeout=60):
        proc.kill()
        proc.communicate()
        raise AssertionError("phase 15: the rendezvous printed no port")
    line = proc.stdout.readline()
    if "rendezvous serving" not in line:
        proc.kill()
        raise AssertionError(f"phase 15: rendezvous said {line!r}")
    return proc, line.split()[-1]


def mp_rank_main(argv) -> int:
    """One rank of phase 15 (`python -P chip_smoke.py --rank R --port P
    --task solve|elastic`): joins the gloo group through the rendezvous
    and runs its task; results to `MP_DIR`."""
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", required=True)
    ap.add_argument("--task", choices=("solve", "elastic"), required=True)
    ap.add_argument("--device", required=True)
    a = ap.parse_args(argv)
    global DEVICE
    DEVICE = torch.device(a.device)
    if a.task == "solve":
        mp_rank_solve(a.rank, a.port, a.device)
    else:
        mp_rank_elastic(a.rank, a.port, a.device)
    log(f"rank {a.rank} OK")
    return 0


def mp_2d_option(task: str):
    """The options of 15.4 (`m2x2`: phase 7's `2x2_implicit`, venice f32,
    `VENICE_LM`) and 15.5 (`m1x2_implicit` / `m1x2_explicit`: the
    trafalgar-sized f64 scene's fused paths on world 2, `cam_blocks` 2,
    which factor_mesh_2d makes 1 x 2, `F64_LM`)."""
    if task == "m2x2":
        return solve_option(np.float32, "2x2_implicit", lm=VENICE_LM)
    base = solve_option(np.float64, "2x2_" + task[5:] + "_fused", lm=F64_LM)
    return dataclasses.replace(base, world_size=2, solver_option=(
        dataclasses.replace(base.solver_option, cam_blocks=2)))


# 15.4 and 15.5: task -> (problem file, this rank's devices).
MP_2D_TASKS = {"m2x2": ("venice", 2), "m1x2_implicit": ("trafalgar", 1),
               "m1x2_explicit": ("trafalgar", 1)}


def mp_rank_device_list(n: int):
    """A rank's devices of a 2-D task: `n` shards on its one device."""
    dev = mp_rank_device()
    return dev if n == 1 else [dev] * n


def mp_rank_solve(rank: int, port: str, device: str) -> None:
    """15.1, 15.2, 15.4 and 15.5 in one rank: the venice world-2 solve,
    the world-2 pose graph, the venice 2 x 2 solve (two shards a rank)
    and the trafalgar-sized 1 x 2 solves (one shard a rank), each with
    this rank's figures."""
    from megba_tpu_torch import flat_solve
    from megba_tpu_torch.models.pgo import solve_pgo
    from megba_tpu_torch.ops import kernels
    from megba_tpu_torch.parallel import collectives
    from megba_tpu_torch.parallel.multihost import (
        initialize_multihost,
        shutdown_multihost,
    )

    t_start = time.perf_counter()
    info = initialize_multihost(f"localhost:{port}", MP_WORLD, rank,
                                elastic=True)
    problems = {}
    for name in ("venice", "trafalgar"):
        with np.load(MP_DIR / f"{name}.npz") as z:
            problems[name] = tuple(z[k] for k in (
                "cameras", "points", "obs", "cam_idx", "pt_idx"))
    opt = solve_option(np.float32, "w2_implicit", lm=VENICE_LM)
    out = {}
    for task in ("ba", "pgo", *MP_2D_TASKS):
        if task == "pgo":
            with np.load(MP_DIR / "graph.npz") as z:
                g = {k: z[k] for k in z.files}
            args, kw, pgo_opt, _ = pgo_path_inputs(
                "se3_w2", {"se3": types.SimpleNamespace(**g)})
        reset_launch_counts()
        collectives.reset_gather_stats()
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with count_shard_launches() as shards:
            if task == "ba":
                res = flat_solve(None, *problems["venice"], opt,
                                 device=device)
            elif task == "pgo":
                res = solve_pgo(*args, pgo_opt, device=device, **kw)
            else:
                scene, n = MP_2D_TASKS[task]
                res = flat_solve(None, *problems[scene], mp_2d_option(task),
                                 device=mp_rank_device_list(n))
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                else 0)
        gathers = collectives.gather_stats()
        rec = dict(wall=wall, peak=peak, cost=res.cost.cpu().numpy(),
                   initial_cost=res.initial_cost.cpu().numpy(),
                   counts=np.asarray([res.iterations, res.accepted,
                                      res.pcg_iterations, res.status]),
                   gathers=gathers["gathers"], gather_bytes=gathers["bytes"],
                   gather_s=gathers["seconds"], hops=gathers["hops"],
                   hop_bytes=gathers["hop_bytes"],
                   hop_s=gathers["hop_seconds"],
                   shards=json.dumps(shards), launches=json.dumps(
                       {k: v for k, v in launch_counts().items() if v}))
        if task == "pgo":
            rec.update(poses=res.poses.cpu().numpy())
        else:
            k = res.iterations
            rec.update(cameras=res.cameras.cpu().numpy(),
                       points=res.points.cpu().numpy(),
                       **{f"trace_{f}": getattr(res.trace, f)[:k].numpy()
                          for f in ("cost", "accept", "pcg_iters", "rho",
                                    "trust_region")})
        out.update({f"{task}_{n}": v for n, v in rec.items()})
    shutdown_multihost()
    np.savez(MP_DIR / f"rank{rank}.npz", backend=info["backend"],
             nvcc_builds=kernels.nvcc_builds(),
             seconds=time.perf_counter() - t_start, **out)


def mp_elastic_config(rank: int, hb_dir: str):
    from megba_tpu_torch.robustness.elastic import ElasticConfig

    return ElasticConfig(heartbeat_dir=hb_dir, rank=rank, world=MP_WORLD,
                         **ELASTIC)


def mp_elastic_option():
    return solve_option(np.float64, "w2_implicit", lm=ELASTIC_LM)


def mp_rank_elastic(rank: int, port: str, device: str) -> None:
    """15.3 in one rank: the chunked world-2 solve under an elastic
    monitor; on a lost peer, the shrink-world resume at world 1."""
    from megba_tpu_torch import solve_checkpointed
    from megba_tpu_torch.parallel.multihost import initialize_multihost
    from megba_tpu_torch.robustness.elastic import (
        CollectiveTimeout,
        ElasticMonitor,
        WorkerLost,
        resume_elastic,
    )

    initialize_multihost(f"localhost:{port}", MP_WORLD, rank, elastic=True)
    with np.load(MP_DIR / "trafalgar.npz") as z:
        arrays = tuple(z[k] for k in ("cameras", "points", "obs", "cam_idx",
                                      "pt_idx"))
    opt = dataclasses.replace(
        mp_elastic_option(),
        telemetry=str(MP_DIR / "elastic.jsonl") if rank == 0 else None)
    ckpt = str(MP_DIR / f"elastic{rank}.npz")
    cfg = mp_elastic_config(rank, str(MP_DIR / "hb"))
    detect = dict(kind="none", latency=float("nan"), at=float("nan"))
    with ElasticMonitor(cfg) as monitor:
        try:
            res = solve_checkpointed(None, *arrays, opt, ckpt, CHUNK_BA,
                                     elastic=monitor, device=device)
        except (WorkerLost, CollectiveTimeout) as exc:
            detect = dict(
                kind=type(exc).__name__, at=time.monotonic(),
                latency=getattr(exc, "detected_after_s",
                                getattr(exc, "elapsed_s", float("nan"))))
            log(f"rank {rank} detected {detect['kind']} after "
                f"{detect['latency']:.3f} s of silence")
            res = resume_elastic(None, *arrays, opt, ckpt, world_size=1,
                                 monitor=monitor, checkpoint_every=CHUNK_BA,
                                 device=device)
    np.savez(MP_DIR / f"elastic_result{rank}.npz",
             cameras=res.cameras.cpu().numpy(),
             points=res.points.cpu().numpy(), cost=res.cost.cpu().numpy(),
             iterations=res.iterations, status=res.status,
             detect_kind=detect["kind"], latency=detect["latency"],
             detect_at=detect["at"])


def mp_2d_references(venice, trafalgar64) -> None:
    """The one-process runs 15.4 and 15.5 are held to: each 2-D task on
    the one card in this process (`[DEVICE] * world`), with its launches
    per shard and its replicated launches (MP_KEPT[task])."""
    from megba_tpu_torch import flat_solve
    from megba_tpu_torch.parallel.collectives import ShardLaunches

    scenes = {"venice": venice, "trafalgar": trafalgar64}
    for task, (scene, _) in MP_2D_TASKS.items():
        s = scenes[scene]
        opt = mp_2d_option(task)
        with ShardLaunches([k for m in kernel_modules()
                            for k in m.KERNELS]) as tally:
            res = flat_solve(None, s.cameras0, s.points0, s.obs, s.cam_idx,
                             s.pt_idx, opt,
                             device=[DEVICE] * opt.world_size)
        shards = {n: dict(sorted(per.items()))
                  for n, per in tally.counts.items() if per}
        MP_KEPT[task] = (res, shards, dict(tally.replicated))


def mp_2d_want_shards(task: str, rank: int, nproc_shards: int) -> dict:
    """A rank's launches per shard that the one-process run implies: its
    shards' own launches, the replicated ones on its first shard (in the
    one-process run they sit on shard 0)."""
    _, shards, replicated = MP_KEPT[task]
    local = range(rank * nproc_shards, (rank + 1) * nproc_shards)
    out = {}
    for name, per in shards.items():
        got = {}
        for k in local:
            n = per.get(k, 0) - (replicated.get(name, 0) if k == 0 else 0)
            if k == local[0]:
                n += replicated.get(name, 0)
            if n:
                got[str(k)] = n
        if got:
            out[name] = got
    return out


def mp_check_2d(recs: dict) -> None:
    """15.4 and 15.5: every rank bitwise the one-process run (trace,
    cameras, points, cost, counts), its launches per shard what that run
    implies, and kernels 7 and 8 in their ring-step form on 15.5."""
    for task, (scene, n) in MP_2D_TASKS.items():
        one = MP_KEPT[task][0]
        k = one.iterations
        want = {"cameras": one.cameras, "points": one.points,
                "cost": one.cost,
                **{f"trace_{f}": getattr(one.trace, f)[:k] for f in (
                    "cost", "accept", "pcg_iters", "rho", "trust_region")}}
        counts = np.asarray([one.iterations, one.accepted,
                             one.pcg_iterations, one.status])
        label = "15.4" if task == "m2x2" else "15.5"
        for r, rec in recs.items():
            for name, ref in want.items():
                got = torch.from_numpy(np.asarray(rec[f"{task}_{name}"]))
                if not bitwise_equal(got, ref.cpu()):
                    raise AssertionError(
                        f"{label} {task} rank {r}: {name} is not bitwise the "
                        "one-process 2-D run")
            if not np.array_equal(rec[f"{task}_counts"], counts):
                raise AssertionError(f"{label} {task} rank {r}: counts "
                                     f"{rec[f'{task}_counts']} != {counts}")
            shards = json.loads(str(rec[f"{task}_shards"]))
            want_shards = mp_2d_want_shards(task, r, n)
            if shards != want_shards:
                raise AssertionError(
                    f"{label} {task} rank {r}: launches per shard {shards}, "
                    f"the one-process run implies {want_shards}")
            if task != "m2x2" and DEVICE.type == "cuda":
                ring = ("fused_ring_step_apply_implicit"
                        if task.endswith("implicit")
                        else "fused_ring_step_apply")
                if not json.loads(str(rec[f"{task}_launches"])).get(ring):
                    raise AssertionError(f"15.5 {task} rank {r}: {ring} "
                                         "never launched")


def mp_solve_ranks(smi: str) -> None:
    """15.1 and 15.2: both ranks, gated against phases 7 and 10."""
    rdv, port = mp_rendezvous()
    procs = []
    outs = {}
    t = time.perf_counter()
    try:
        for r in range(MP_WORLD):
            procs.append(subprocess.Popen(
                [sys.executable, "-P", str(ROOT / "chip_smoke.py"), "--rank",
                 str(r), "--port", port, "--task", "solve", "--device",
                 mp_rank_device()], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=mp_env()))
        for r, p in enumerate(procs):
            outs[r], _ = p.communicate(timeout=MP_RANK_TIMEOUT_S)
    finally:
        for p in procs + [rdv]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t
    for r, p in enumerate(procs):
        if p.returncode != 0 or f"rank {r} OK" not in outs[r]:
            raise AssertionError(f"phase 15: rank {r} failed (rc "
                                 f"{p.returncode}):\n{outs[r][-4000:]}")
    recs = {r: dict(np.load(MP_DIR / f"rank{r}.npz"))
            for r in range(MP_WORLD)}
    one, one_shards = MP_KEPT["venice"]
    k = one.iterations
    want = {"cameras": one.cameras, "points": one.points,
            **{f"trace_{f}": getattr(one.trace, f)[:k] for f in (
                "cost", "accept", "pcg_iters", "rho", "trust_region")}}
    counts = np.asarray([one.iterations, one.accepted, one.pcg_iterations,
                         one.status])
    g_kern = MP_KEPT["pgo"]
    for r, rec in recs.items():
        if int(rec["nvcc_builds"]) != 0:
            raise AssertionError(f"phase 15: rank {r} ran nvcc")
        for name, ref in want.items():
            got = torch.from_numpy(rec[f"ba_{name}"])
            if not bitwise_equal(got, ref.cpu()):
                raise AssertionError(f"15.1 rank {r}: {name} is not bitwise "
                                     "phase 7's one-process world-2 run")
        if not (np.array_equal(rec["ba_counts"], counts) and bitwise_equal(
                torch.from_numpy(rec["ba_cost"]), one.cost.cpu())):
            raise AssertionError(f"15.1 rank {r}: counts or cost differ")
        shards = json.loads(str(rec["ba_shards"]))
        want_shards = {n: {str(r): per[0]} for n, per in one_shards.items()}
        if shards != want_shards:
            raise AssertionError(
                f"15.1 rank {r}: launches {shards}, phase 7's shard-0 tally "
                f"implies {want_shards}")
        if not (bitwise_equal(torch.from_numpy(rec["pgo_poses"]),
                              g_kern.poses.cpu())
                and bitwise_equal(torch.from_numpy(rec["pgo_cost"]),
                                  g_kern.cost.cpu())
                and list(rec["pgo_counts"]) == [
                    g_kern.iterations, g_kern.accepted,
                    g_kern.pcg_iterations, g_kern.status]):
            raise AssertionError(f"15.2 rank {r}: not bitwise phase 10's "
                                 "one-process world-2 graph")
    mp_check_2d(recs)
    for r, rec in recs.items():
        for task, what in (
                ("ba", "venice f32 IMPLICIT world 2"),
                ("pgo", "4,096-pose SE(3) f64 world 2"),
                ("m2x2", "venice f32 IMPLICIT 2 x 2 (rows across the ranks)"),
                ("m1x2_implicit", "trafalgar-sized f64 fused IMPLICIT 1 x 2 "
                 "(every ring hop across the ranks)"),
                ("m1x2_explicit", "trafalgar-sized f64 fused EXPLICIT 1 x 2 "
                 "(every ring hop across the ranks)")):
            iters = int(rec[f"{task}_counts"][0])
            call = "solve_pgo" if task == "pgo" else "flat_solve"
            log(f"multi-process {what}, rank {r} of {MP_WORLD} on "
                f"{mp_rank_device()} ({rec['backend']}): {call} "
                f"{float(rec[f'{task}_wall']):.3f} s, {iters} LM iterations, "
                f"peak memory {int(rec[f'{task}_peak']) / 2**30:.3f} GiB; "
                f"{int(rec[f'{task}_gathers'])} gathers, "
                f"{int(rec[f'{task}_gather_bytes']) / 2**20:.3f} MiB "
                f"received, {1e3 * float(rec[f'{task}_gather_s']):.1f} ms "
                "of host time in them = "
                f"{int(rec[f'{task}_gather_bytes']) / 2**20 / iters:.3f} MiB "
                f"and {1e3 * float(rec[f'{task}_gather_s']) / iters:.1f} ms "
                f"per LM iteration; {int(rec[f'{task}_hops'])} ring hops "
                f"across the ranks (sent and received), "
                f"{int(rec[f'{task}_hop_bytes']) / 2**20:.3f} MiB received, "
                f"{1e3 * float(rec[f'{task}_hop_s']):.1f} ms of host time = "
                f"{int(rec[f'{task}_hops']) / iters:.1f} hops, "
                f"{int(rec[f'{task}_hop_bytes']) / 2**20 / iters:.3f} MiB "
                f"and {1e3 * float(rec[f'{task}_hop_s']) / iters:.1f} ms per "
                f"LM iteration; launches {rec[f'{task}_launches']}; {smi}")
        log(f"multi-process rank {r}: {float(rec['seconds']):.1f} s from "
            "its start to its results (rendezvous, problem load, both "
            "solves), no nvcc build")
    log(f"multi-process 15.1 / 15.2: both ranks bitwise the one-process "
        f"world-2 runs (venice trace, cameras, points; the graph's poses, "
        f"costs, counts, status); each rank's launches phase 7's shard-0 "
        f"tally (its shard plus the replicated work); 15.4 / 15.5: both "
        f"ranks bitwise the one-process 2 x 2 venice and 1 x 2 "
        f"trafalgar-sized runs (trace, cameras, points, cost, counts), each "
        f"rank's launches per shard the one-process tally of its shards "
        f"(the replicated work on its first), kernels 7 and 8 in their "
        f"ring-step form in both ranks; {wall:.1f} s from the ranks' start "
        f"to their exit; {smi}")


def mp_elastic(trafalgar64, smi: str) -> None:
    """15.3: the elastic kill-resume across two ranks, gated against the
    parent's uninterrupted world-2 run."""
    from megba_tpu_torch import solve_checkpointed
    from megba_tpu_torch.robustness.harness import (
        run_world_until_snapshot_then_kill,
    )
    from megba_tpu_torch.utils.checkpoint import load_state

    arrays = (trafalgar64.cameras0, trafalgar64.points0, trafalgar64.obs,
              trafalgar64.cam_idx, trafalgar64.pt_idx)
    np.savez(MP_DIR / "trafalgar.npz", **dict(zip(
        ("cameras", "points", "obs", "cam_idx", "pt_idx"), arrays)))
    t = time.perf_counter()
    clean = solve_checkpointed(None, *arrays, mp_elastic_option(),
                               str(MP_DIR / "clean.npz"), CHUNK_BA,
                               device=[DEVICE] * MP_WORLD)
    t_clean = time.perf_counter() - t

    def ranks(line):
        port = line.split()[-1]
        return [[sys.executable, "-P", str(ROOT / "chip_smoke.py"), "--rank",
                 str(r), "--port", port, "--task", "elastic", "--device",
                 mp_rank_device()] for r in range(MP_WORLD)]

    t = time.perf_counter()
    outcome = run_world_until_snapshot_then_kill(
        [], str(MP_DIR / "elastic0.npz"), kill_rank=1,
        rendezvous_argv=[sys.executable, "-P", "-m",
                         "megba_tpu_torch.parallel.multihost", "--serve",
                         "0", str(MP_WORLD)],
        timeout=MP_RANK_TIMEOUT_S, survivor_timeout=MP_RANK_TIMEOUT_S,
        env=mp_env(), worker_argvs_after_rendezvous=ranks)
    wall = time.perf_counter() - t
    if outcome.returncodes[1] >= 0 or outcome.returncodes[0] != 0:
        raise AssertionError(f"15.3: return codes {outcome.returncodes}:\n"
                             f"{outcome.outputs[0][-4000:]}")
    res = dict(np.load(MP_DIR / "elastic_result0.npz"))
    cfg = mp_elastic_config(0, str(MP_DIR / "hb"))
    limit = cfg.dead_after_s + 10 * cfg.poll_s
    latency = float(res["latency"])
    from_kill = float(res["detect_at"]) - outcome.kill_monotonic
    if str(res["detect_kind"]) != "WorkerLost" or not (
            cfg.dead_after_s <= latency <= limit and from_kill <= limit):
        raise AssertionError(
            f"15.3: detected {res['detect_kind']} after {latency:.3f} s of "
            f"silence, {from_kill:.3f} s after the kill (limit {limit} s)")
    final = load_state(str(MP_DIR / "elastic0.npz"))
    if int(final["world_size"]) != 1 or int(final["iteration"]) != int(
            res["iterations"]):
        raise AssertionError("15.3: the snapshot chain did not end at "
                             "world 1")
    if (int(res["iterations"]), int(res["status"])) != (
            clean.iterations, clean.status):
        raise AssertionError("15.3: iterations or status differ from the "
                             "uninterrupted world-2 run")
    gaps = {}
    for name, got, ref, atol in (
            ("cost", res["cost"], clean.cost, 0.0),
            ("cameras", res["cameras"], clean.cameras, 1e-9),
            ("points", res["points"], clean.points, 1e-9)):
        ref = ref.cpu().numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=atol,
                                   err_msg=f"15.3 {name}")
        gaps[name] = float(np.max(np.abs(got - ref) / np.maximum(
            np.abs(ref), 1e-300)))
    block = json.loads((MP_DIR / "elastic.jsonl").read_text().splitlines()[
        -1])["elastic"]
    if (block["workers_lost"], block["reshards"], block["resumes"]) != (
            1, 1, 1):
        raise AssertionError(f"15.3: elastic block {block}")
    log(f"multi-process 15.3 elastic kill-resume (trafalgar-sized f64, "
        f"{ELASTIC_LM} LM in chunks of {CHUNK_BA}): rank 1 SIGKILLed at rank "
        f"0's first world-2 snapshot; rank 0 raised WorkerLost after "
        f"{latency:.3f} s of silence, {from_kill:.3f} s after the kill "
        f"(dead_after_s {cfg.dead_after_s}, poll {cfg.poll_s} s), resumed "
        f"at world 1 and exited 0; {int(res['iterations'])} LM, status "
        f"{int(res['status'])}, relative gaps to the uninterrupted world-2 "
        f"run {gaps} (rtol 1e-6); elastic block {block['workers_lost']} "
        f"lost / {block['reshards']} reshard / {block['resumes']} resume; "
        f"{wall:.1f} s from the rendezvous' start to rank 0's exit, the "
        f"uninterrupted run {t_clean:.1f} s; {smi}")


def mp_gloo_device_probe() -> str:
    """Whether gloo takes the card's tensors in an all_gather, probed in
    a process group of one (this process): the port stages the gathered
    parts through host memory either way (parallel/collectives.py), so
    the answer is recorded, not used."""
    import torch.distributed as dist

    if DEVICE.type != "cuda":
        return "gloo on the card: not probed (no card)"
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        x = torch.arange(4.0, device=DEVICE)
        out = [torch.empty_like(x)]
        dist.all_gather(out, x)
        torch.cuda.synchronize()
        how = "works" if torch.equal(out[0], x) else "returned wrong values"
        return f"gloo on the card: all_gather of a CUDA tensor {how}"
    except Exception as exc:  # recorded: the port does not use this path
        return (f"gloo on the card: all_gather of a CUDA tensor raised "
                f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}")
    finally:
        dist.destroy_process_group()


def multiprocess_phase(venice, trafalgar64, smi: str) -> None:
    """Phase 15 (the module docstring): 15.1 and 15.2 in one pair of
    ranks, then 15.3 in another."""
    import shutil

    shutil.rmtree(MP_DIR, ignore_errors=True)
    MP_DIR.mkdir(parents=True)
    np.savez(MP_DIR / "venice.npz", cameras=venice.cameras0,
             points=venice.points0, obs=venice.obs, cam_idx=venice.cam_idx,
             pt_idx=venice.pt_idx)
    g = MP_KEPT["pgo_graph"]
    np.savez(MP_DIR / "graph.npz", poses0=g.poses0, edge_i=g.edge_i,
             edge_j=g.edge_j, meas=g.meas)
    if DEVICE.type == "cuda":
        torch.cuda.empty_cache()
    np.savez(MP_DIR / "trafalgar.npz", cameras=trafalgar64.cameras0,
             points=trafalgar64.points0, obs=trafalgar64.obs,
             cam_idx=trafalgar64.cam_idx, pt_idx=trafalgar64.pt_idx)
    log(f"multi-process: {mp_gloo_device_probe()}; the port stages each "
        "gathered part and each ring hop through host memory")
    t = time.perf_counter()
    mp_2d_references(venice, trafalgar64)
    log(f"multi-process: the one-process 2-D references of 15.4 / 15.5 in "
        f"{time.perf_counter() - t:.1f} s")
    mp_solve_ranks(smi)
    mp_elastic(trafalgar64, smi)
    shutil.rmtree(MP_DIR, ignore_errors=True)



# ---------------------------------------------------------------------------
# Phase 16: the analysis lanes on the card
# ---------------------------------------------------------------------------


def audit_phase(smi: str) -> None:
    """Phase 16: the census of the canonical specs on the card
    (analysis/program_audit.py), each spec's per-iteration counts equal
    to the committed budget the CPU census gives, with the host
    synchronisations `torch.cuda.set_sync_debug_mode` reports; then the
    strict-dtype lane's BA and PGO solves on the card
    (analysis/strict_dtype.py), where the kernels' wrappers run."""
    from megba_tpu_torch.analysis import program_audit, strict_dtype

    t = time.perf_counter()
    records = program_audit.audit_all(device=str(DEVICE))
    t_census = time.perf_counter() - t
    bad = program_audit.check_against(records, program_audit.load_budget())
    for name, rec in records.items():
        syncs = rec.get("syncs", {"per_lm": "not measured",
                                  "per_pcg": "not measured"})
        log(f"audit {name} on {DEVICE}: {rec['lm_iterations']} LM / "
            f"{rec['pcg_iterations']} PCG iterations; per LM iteration "
            f"{rec['per_lm']}, per PCG iteration {rec['per_pcg']}; host "
            f"synchronisations (set_sync_debug_mode) per LM iteration "
            f"{syncs['per_lm']}, per PCG iteration {syncs['per_pcg']}"
            + (f" (the LM iterations' raised at {rec['lm_sync_sites']})"
               if "lm_sync_sites" in rec else ""))
    if bad:
        raise AssertionError("phase 16: the card's census differs from the "
                             "committed budget:\n" + "\n".join(bad))
    t = time.perf_counter()
    info = strict_dtype.run_lane(str(DEVICE))
    log(f"audit: {len(records)} specs equal the CPU census and "
        f"audit_budget.json ({t_census:.1f} s); strict-dtype lane on "
        f"{DEVICE}: BA f32 and f64 and PGO f32 solves, {info['ops']} ops "
        f"checked, no float mix outside the declared arms and no NaN "
        f"(the solves inject no fault) ({time.perf_counter() - t:.1f} s); "
        f"{smi}")


class PhaseClock:
    """Wall seconds of the script's phases, each from the end of the one
    before (the first from the end of the build, `build_s`)."""

    def __init__(self, build_s: float) -> None:
        from megba_tpu_torch.ops import segtiles

        self.laps = [("build", build_s)]
        self.t = time.perf_counter()
        self.cache = segtiles.plan_cache_counts()

    def lap(self, name: str) -> None:
        """Log the phase's wall and the plan-cache lookups inside it: a
        phase with hits re-solved a graph it had planned, and its walls
        hold those hits' lookups in place of planning."""
        from megba_tpu_torch.ops import segtiles

        now = time.perf_counter()
        self.laps.append((name, now - self.t))
        self.t = now
        log(f"phase {name}: {self.laps[-1][1]:.1f} s (plan cache: "
            f"{plan_cache_words(self.cache)})")
        self.cache = segtiles.plan_cache_counts()

    def summary(self) -> str:
        return ("phase times: " + ", ".join(f"{n} {s:.1f} s"
                                            for n, s in self.laps)
                + f"; {sum(s for _, s in self.laps):.1f} s in all")


def main() -> int:
    if "--rank" in sys.argv[1:]:  # a rank process of phase 15
        return mp_rank_main(sys.argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "megba_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(megba_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # The library yardstick's CSR tensors are a beta feature of PyTorch.
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
    warnings.filterwarnings("ignore", message="Sparse invariant checks")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from megba_tpu_torch.ops import kernels

    sources = [src for m in kernel_modules() for src in m.KERNEL_SOURCES]
    t = time.perf_counter()
    kernels.build_all(sources)
    log(f"build: {time.perf_counter() - t:.1f} s for {len(sources)} "
        f"source(s) into {kernels.BUILD_DIR}")
    kernel_resources(kernels.BUILD_LOGS)
    smi = nvidia_smi_line()
    log(smi)

    from megba_tpu_torch.analysis import retrace

    # No kernel library may be built after phase 1 (checked at the end).
    rebuilds = retrace.sentinel(max_compiles=0, sites=["kernel_build"])
    rebuilds.__enter__()
    clock = PhaseClock(time.perf_counter() - t)
    venice = make_scene(VENICE, np.float32)
    rows = kernel_phase(venice)
    clock.lap("kernels (venice scene included)")
    engine_phase(venice)
    clock.lap("engines")
    trafalgar64 = make_scene(TRAFALGAR, np.float64)
    f64_counts = f64_phase(trafalgar64,
                           make_scene(TRAFALGAR_GRID, np.float64))
    for row, arm_path in F64_ARM_PATHS.items():
        rows[row]["launches"] = f64_counts[arm_path].get(row, 0)
    clock.lap("f64")
    trafalgar32 = make_scene(TRAFALGAR, np.float32)
    precision_phase(trafalgar32)
    clock.lap("f32 precision")
    ref = None
    for path in VENICE_PATHS:
        _, _, rung, kernels_of_path = PATHS[path]
        counts, arms, res, wall = venice_phase(venice, path,
                                               opts.profile, ref)
        if ref is None:  # the IMPLICIT run, phase 11's straight solve
            ref, straight = res, (counts, res, wall)
        for name in kernels_of_path:  # the first f32 path that runs it
            if rung is None and rows[name]["launches"] is None:
                rows[name]["launches"] = counts[name]
        for row, arm_path in ARM_PATHS.items():
            if arm_path == path:
                rows[row]["launches"] = arms.get(row, 0)
    clock.lap("venice")
    locality = make_scene(LOCALITY, np.float32)
    locality_phase(locality, opts.profile)
    clock.lap("locality")
    rows.update(factor_phase(venice, trafalgar64))
    clock.lap("factor")
    pgo_kept = {}
    rows.update(pgo_phase(pgo_kept))
    clock.lap("pgo")
    chunked = durable_phase(venice, trafalgar64, straight, pgo_kept)
    clock.lap("durable")
    fleet_kept = {}
    rows.update(fleet_phase(fleet_kept))
    clock.lap("fleet")
    federation_phase(fleet_kept, clock.laps[0][1], smi)
    clock.lap("federation")
    host_tools_phase(venice, locality, trafalgar32, chunked, smi)
    clock.lap("host tools")
    multiprocess_phase(venice, trafalgar64, smi)
    clock.lap("multi-process")
    audit_phase(smi)
    clock.lap("audit")
    # Phase 9's pan-tilt edge builds its shapes at first use by design
    # (none when an earlier run left them in the build directory): those
    # libraries, each at most once, and no other after phase 1.
    rebuilds.allow(extra_compiles=len(FIRST_USE_LIBRARIES))
    rebuilds.check()
    built = tuple(sorted(sig.split("-")[0] for _, _, sig
                         in rebuilds.new_compiles()))
    if not set(built) <= set(FIRST_USE_LIBRARIES):
        raise AssertionError(f"retrace sentinel: libraries built after "
                             f"phase 1 {built}, expected only phase 9's "
                             f"first-use shapes {FIRST_USE_LIBRARIES}")
    log(f"retrace sentinel: after phase 1 no kernel library was built but "
        f"phase 9's first-use shapes {list(built)}, each once "
        f"({retrace.site_totals(['kernel_build']).get('kernel_build', 0)} "
        f"nvcc builds in all)")
    log(clock.summary())
    missing = [r["name"] for r in rows.values() if not r["launches"]]
    if missing:
        raise AssertionError(f"kernel rows never launched on their "
                             f"path: {missing}")

    log(smi)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
