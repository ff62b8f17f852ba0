#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (megba_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--profile]

Phases, in order; none catches its own failure, so any mismatch or
exception ends the run with a non-zero exit code:

1. build: every CUDA source of megba_tpu_torch/csrc with nvcc for sm_90a
   (all sources started together), and print the build time;
2. the card's name and power limit, as nvidia-smi gives them;
3. kernels: at the venice shapes, f32, each of the seven kernels on each
   side or direction it runs on (camera d=9, point d=3) against its plain
   PyTorch version on the same inputs, a bitwise repeat, and CUDA-event
   medians of the kernel, the plain version and, where one exists, one
   PyTorch library call that computes the same function (a cuSPARSE CSR
   product, `torch.segment_reduce`, `index_select`, an einsum);
4. f64: a trafalgar-sized scene solved end to end IMPLICIT, EXPLICIT and
   EXPLICIT with fused kernels, each through the kernels and through the
   plain versions, both on the card; the two cost trajectories agree at
   rtol 1e-9 with the same accept pattern and iteration counts;
5. venice: the venice configuration (1778 cameras, 993,923 points,
   ~5.0M observations, f32, ANALYTICAL) through `flat_solve`, the port's
   main path, once per path: IMPLICIT, EXPLICIT, EXPLICIT + fused
   kernels.  Every kernel's launch count is read from its path's run
   alone and checked against the count the code implies; the final cost
   must be finite and below the initial.

The last two lines of standard output are the `kernels` JSON object and
`{"ok": true, "device": {...}}`.  `--profile` adds a torch.profiler
pass over a second venice solve of each path and writes its kernel
table to chiprun_out/.  The scenes are fixed: a quick check of a new
kernel build is the `cuda`-marked test, `pytest -m cuda
tests/test_torch_cuda.py`.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
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
F64_COST_RTOL = 1e-9

VENICE = dict(num_cameras=1778, num_points=993_923,
              obs_per_point=5_001_946 / 993_923)
TRAFALGAR = dict(num_cameras=257, num_points=65_132,
                 obs_per_point=225_911 / 65_132)
REPLACES = {
    "jtj_grad_reduce": "megba_tpu/ops/segtiles.py:469",
    "coupling_expand": "megba_tpu/ops/segtiles.py:624",
    "coupling_reduce": "megba_tpu/ops/segtiles.py:688",
    "seg_reduce": "megba_tpu/ops/segtiles.py:279",
    "seg_expand": "megba_tpu/ops/segtiles.py:336",
    "fused_coupling_apply": "megba_tpu/ops/fused.py:500",
    "fused_block_diag_apply": "megba_tpu/ops/fused.py:647",
}
# The solve paths of phases 4 and 5: (compute kind, fused_kernels, the
# kernels the path must launch).
PATHS = {
    "implicit": ("IMPLICIT", False,
                 ("jtj_grad_reduce", "coupling_expand", "coupling_reduce")),
    "explicit": ("EXPLICIT", False,
                 ("jtj_grad_reduce", "coupling_expand", "seg_expand",
                  "seg_reduce")),
    "explicit_fused": ("EXPLICIT", True,
                       ("jtj_grad_reduce", "coupling_expand",
                        "fused_coupling_apply", "fused_block_diag_apply")),
}


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


def solve_option(dtype, path: str = "implicit"):
    from megba_tpu_torch import (AlgoOption, ComputeKind, JacobianMode,
                                 ProblemOption, SolverOption)

    kind, fused, _ = PATHS[path]
    return ProblemOption(
        dtype=dtype, compute_kind=ComputeKind[kind],
        jacobian_mode=JacobianMode.ANALYTICAL,
        algo_option=AlgoOption(max_iter=8, epsilon1=1e-12, epsilon2=1e-15),
        solver_option=SolverOption(max_iter=30, tol=1e-10, refuse_ratio=1e30,
                                   fused_kernels=fused))


def kernel_modules():
    """The port's kernel modules; every kernel wrapper lives in one."""
    from megba_tpu_torch.ops import fused, segtiles

    return segtiles, fused


def kernel_module(name: str):
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


def kernel_source(name: str) -> str:
    return ("megba_tpu_torch/csrc/"
            f"{kernel_module(name).KERNEL_SOURCES[0]}.cu")


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


def _case(side, args, abs_args, nbytes, flops, library=None):
    """One side of a kernel: its arguments, the same arguments with every
    float operand made |.| (the scale of the f32 check), the bytes the
    kernel must move and the operations it must do, and a zero-argument
    function that builds the library yardstick's call (or None)."""
    return dict(side=side, args=args, abs_args=abs_args, bytes=nbytes,
                flops=flops, library=library)


def _plan_of(args):
    from megba_tpu_torch.ops.segtiles import SegPlan

    for a in args:
        if isinstance(a, SegPlan):
            return a
        if hasattr(a, "out") and isinstance(a.out, SegPlan):
            return a.out
    return None


def kernel_phase(scene) -> dict:
    from megba_tpu_torch.core.fm import coupling_rows
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
    # direction, in point-slot order; the damped, inverted Hpp blocks.
    r, Jc, Jp_cam = bal_residual_jacobian_analytical_fm(
        fm(scene.cameras0[scene.cam_idx[perm]]),
        fm(scene.points0[scene.pt_idx[perm]]), fm(scene.obs[perm]))
    Jp = plans.to_pt(Jp_cam).contiguous()
    W = coupling_rows(Jc, Jp_cam, 2).contiguous()
    W_tp = plans.to_pt(W).contiguous()
    del Jp_cam
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
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32)

    x_cam, x_pt = randn(9, nc), randn(3, npt)
    u_cam, u_pt = randn(2, n), randn(2, n)
    d_cam, d_pt = randn(9, n), randn(3, n)
    to_pt, to_cam = plans.fused_to_pt, plans.fused_to_cam
    es = 4  # f32 bytes
    i32, i64 = 4, 8

    def lengths(plan, F):
        return (plan.seg_ptr[1:] - plan.seg_ptr[:-1]).expand(
            F, plan.num_segments).contiguous()

    len_cam, len_pt = lengths(plans.cam, 9), lengths(plans.pt, 3)

    cases = {
        "jtj_grad_reduce": [
            _case("cam", (Jc, r, plans.cam), (Jc.abs(), r.abs(), plans.cam),
                  (20 * n + 90 * nc) * es + (nc + 1) * i64,
                  n * (2 * 2 * 81 + 2 * 2 * 9)),
            _case("pt", (Jp, r_pt, plans.pt),
                  (Jp.abs(), r_pt.abs(), plans.pt),
                  (8 * n + 12 * npt) * es + (npt + 1) * i64,
                  n * (2 * 2 * 9 + 2 * 2 * 3)),
        ],
        "coupling_expand": [
            _case("cam", (x_cam, Jc, plans.cam, 9),
                  (x_cam.abs(), Jc.abs(), plans.cam, 9),
                  (9 * nc + 18 * n + 2 * n) * es + n * i32, n * 2 * 18,
                  lambda: _spmv(_csr_expand, Jc, plans.cam.seg, 9, nc,
                                vec=x_cam, shape=(2, n))),
            _case("pt", (x_pt, Jp, plans.pt, 3),
                  (x_pt.abs(), Jp.abs(), plans.pt, 3),
                  (3 * npt + 6 * n + 2 * n) * es + n * i32, n * 2 * 6,
                  lambda: _spmv(_csr_expand, Jp, plans.pt.seg, 3, npt,
                                vec=x_pt, shape=(2, n))),
        ],
        "coupling_reduce": [
            _case("cam", (Jc, u_cam, plans.cam, 9),
                  (Jc.abs(), u_cam.abs(), plans.cam, 9),
                  (18 * n + 2 * n + 9 * nc) * es + (nc + 1) * i64,
                  n * 2 * 18,
                  lambda: _spmv(_csr_reduce, Jc, plans.cam.seg, 9, nc,
                                vec=u_cam, shape=(9, nc))),
            _case("pt", (Jp, u_pt, plans.pt, 3),
                  (Jp.abs(), u_pt.abs(), plans.pt, 3),
                  (6 * n + 2 * n + 3 * npt) * es + (npt + 1) * i64,
                  n * 2 * 6,
                  lambda: _spmv(_csr_reduce, Jp, plans.pt.seg, 3, npt,
                                vec=u_pt, shape=(3, npt))),
        ],
        "seg_reduce": [
            _case("cam", (d_cam, plans.cam), (d_cam.abs(), plans.cam),
                  (9 * n + 9 * nc) * es + (nc + 1) * i64, 9 * n,
                  lambda: lambda: torch.segment_reduce(
                      d_cam, "sum", lengths=len_cam, axis=1, unsafe=True)),
            _case("pt", (d_pt, plans.pt), (d_pt.abs(), plans.pt),
                  (3 * n + 3 * npt) * es + (npt + 1) * i64, 3 * n,
                  lambda: lambda: torch.segment_reduce(
                      d_pt, "sum", lengths=len_pt, axis=1, unsafe=True)),
        ],
        "seg_expand": [
            _case("cam", (x_cam, plans.cam), (x_cam.abs(), plans.cam),
                  (9 * nc + 9 * n) * es + n * i32, 0,
                  lambda: lambda: x_cam.index_select(1, plans.cam.seg)),
            _case("pt", (x_pt, plans.pt), (x_pt.abs(), plans.pt),
                  (3 * npt + 3 * n) * es + n * i32, 0,
                  lambda: lambda: x_pt.index_select(1, plans.pt.seg)),
        ],
        "fused_coupling_apply": [
            _case("cam_to_pt", (W_tp, x_cam, to_pt, True),
                  (W_tp.abs(), x_cam.abs(), to_pt, True),
                  (27 * n + 9 * nc + 3 * npt) * es + n * i32
                  + (npt + 1) * i64, n * 2 * 27,
                  lambda: _spmv(_csr_coupling, W_tp, to_pt, 9, True,
                                vec=x_cam, shape=(3, npt))),
            _case("pt_to_cam", (W, x_pt, to_cam, False),
                  (W.abs(), x_pt.abs(), to_cam, False),
                  (27 * n + 3 * npt + 9 * nc) * es + n * i32
                  + (nc + 1) * i64, n * 2 * 27,
                  lambda: _spmv(_csr_coupling, W, to_cam, 3, False,
                                vec=x_pt, shape=(9, nc))),
        ],
        "fused_block_diag_apply": [
            _case("cam", (Hrows, x_cam), (Hrows.abs(), x_cam.abs()),
                  (81 * nc + 9 * nc + 9 * nc) * es, nc * 2 * 81,
                  lambda: lambda: torch.einsum("nij,jn->in", Minv, x_cam)),
        ],
    }
    rows = {}
    for name, sides in cases.items():
        module = kernel_module(name)
        kernel = getattr(module, name)
        plain = getattr(module, name + "_plain")
        entry = dict(name=name, route="cuda", source=kernel_source(name),
                     replaces=REPLACES[name], launches=None,
                     max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                     bound_by=None, library_ms=0.0, sides={})
        worst = (0.0, None)
        for c in sides:
            side, args = c["side"], c["args"]
            got = _flat(kernel(*args))
            again = _flat(kernel(*args))
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name}[{side}]: two launches differ")
            ref = _flat(plain(*args))
            scale = _flat(plain(*c["abs_args"])).abs()
            err = (got - ref).abs()
            if not bool((err <= F32_REL_TO_ABS_SUM * scale).all()):
                raise AssertionError(
                    f"{name}[{side}]: kernel disagrees with plain version "
                    f"(max |err| {float(err.max()):.3e})")
            lib_ms = None
            if c["library"] is not None:
                run = c["library"]()
                lib_err = (run() - ref).abs()
                if not bool((lib_err <= F32_REL_TO_ABS_SUM * scale).all()):
                    raise AssertionError(
                        f"{name}[{side}]: library yardstick disagrees")
                lib_ms = cuda_ms(run)
                del run
            k_ms = cuda_ms(lambda: kernel(*args))
            p_ms = cuda_ms(lambda: plain(*args), reps=5)
            nbytes, flops = c["bytes"], c["flops"]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            e_max = float(err.max())
            plan = _plan_of(args)
            entry["sides"][side] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, bytes=nbytes, flops=flops, max_abs_err=e_max,
                per_thread=None if plan is None else plan.per_thread)
            entry["ms"] += k_ms
            entry["plain_ms"] += p_ms
            entry["bound_ms"] += bound
            entry["library_ms"] = (None if lib_ms is None or
                                   entry["library_ms"] is None
                                   else entry["library_ms"] + lib_ms)
            entry["max_abs_err"] = max(entry["max_abs_err"], e_max)
            if bound > worst[0]:
                worst = (bound, by)
            log(f"kernel {name}[{side}]: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                f"bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB at "
                f"3.35 TB/s), {bound / k_ms:.1%} of bound, max |err| "
                f"{e_max:.3e}, bitwise repeat ok")
        entry["bound_by"] = worst[1]
        rows[name] = entry
    return rows


# ---------------------------------------------------------------------------
# Phase 4: small f64 end to end, kernels against plain versions
# ---------------------------------------------------------------------------


def f64_phase(scene) -> None:
    """Each path on the trafalgar-sized f64 scene, kernels against plain
    versions; the counts are read from each path's kernel run alone."""
    from megba_tpu_torch import flat_solve

    for path, (_, _, kernels) in PATHS.items():
        opt = solve_option(np.float64, path)
        args = (scene.cameras0, scene.points0, scene.obs, scene.cam_idx,
                scene.pt_idx, opt)
        reset_launch_counts()
        t = time.perf_counter()
        res_k = flat_solve(*args, device=DEVICE)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t
        counts = launch_counts()
        skipped = [k for k in kernels if counts[k] == 0]
        if skipped:
            raise AssertionError(
                f"f64 {path}: the kernel path skipped {skipped}: {counts}")
        with plain_path():
            t = time.perf_counter()
            res_p = flat_solve(*args, device=DEVICE)
            torch.cuda.synchronize()
            t_p = time.perf_counter() - t
        k = res_k.iterations
        if (k, res_k.accepted, res_k.pcg_iterations) != (
                res_p.iterations, res_p.accepted, res_p.pcg_iterations):
            raise AssertionError(
                f"f64 {path}: iteration counts differ: kernels "
                f"{(k, res_k.accepted, res_k.pcg_iterations)}, plain "
                f"{(res_p.iterations, res_p.accepted, res_p.pcg_iterations)}")
        tk, tp = res_k.trace, res_p.trace
        if not torch.equal(tk.accept[:k], tp.accept[:k]) or not torch.equal(
                tk.pcg_iters[:k], tp.pcg_iters[:k]):
            raise AssertionError(
                f"f64 {path}: accept pattern or PCG counts differ")
        ck, cp = tk.cost[:k].numpy(), tp.cost[:k].numpy()
        rel = float(np.max(np.abs(ck - cp) / np.abs(cp))) if k else 0.0
        if not rel <= F64_COST_RTOL:
            raise AssertionError(
                f"f64 {path}: cost trajectories differ (rel {rel:.3e})")
        c0, c1 = float(res_k.initial_cost), float(res_k.cost)
        if not (np.isfinite(c1) and c1 < c0):
            raise AssertionError(f"f64 {path}: cost did not fall "
                                 f"({c0} -> {c1})")
        log(f"f64 {path}: {k} LM iterations, {res_k.pcg_iterations} PCG, "
            f"cost {c0:.10e} -> {c1:.10e}, max rel cost gap kernels/plain "
            f"{rel:.3e} (limit {F64_COST_RTOL:g}), accept pattern equal; "
            f"solve {t_k:.2f} s with kernels, {t_p:.2f} s plain; "
            f"launches {counts}")


# ---------------------------------------------------------------------------
# Phase 5: the main path at full width
# ---------------------------------------------------------------------------


def expected_launches(path: str, res) -> dict:
    """Launch counts the code implies for one solve: with k PCG
    iterations an LM iteration runs hpl and hlp k+2 times each (reduced
    RHS, k+1 S.p products, back-substitution), the preconditioner k+1
    times, and two `coupling_expand` for the gain ratio; each
    linearisation runs `jtj_grad_reduce` twice."""
    L, P, A = res.iterations, res.pcg_iterations, res.accepted
    products = 2 * P + 4 * L  # sum over LM iterations of 2k+4
    want = dict.fromkeys(launch_counts(), 0)
    want["jtj_grad_reduce"] = 2 + 2 * A
    want["coupling_expand"] = 2 * L
    if path == "implicit":
        want["coupling_expand"] += products  # one expand per product
        want["coupling_reduce"] = products
    elif path == "explicit":
        want["seg_expand"] = want["seg_reduce"] = products
    else:
        want["fused_coupling_apply"] = products
        want["fused_block_diag_apply"] = P + L
    return want


def venice_phase(scene, path: str, profile: bool, ref_cost=None):
    from megba_tpu_torch import flat_solve

    opt = solve_option(np.float32, path)
    args = (scene.cameras0, scene.points0, scene.obs, scene.cam_idx,
            scene.pt_idx, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    res = flat_solve(*args, verbose=True, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    c0, c1 = float(res.initial_cost), float(res.cost)
    skipped = [k for k in PATHS[path][2] if counts[k] == 0]
    if skipped:
        raise AssertionError(
            f"venice {path}: never launched {skipped}: {counts}")
    want = expected_launches(path, res)
    if counts != want:
        raise AssertionError(f"venice {path}: launches {counts}, the code "
                             f"implies {want}")
    if not (np.isfinite(c1) and c1 < c0):
        raise AssertionError(f"venice {path}: cost did not fall "
                             f"({c0} -> {c1})")
    if res.cameras.shape != scene.cameras0.shape or not bool(
            torch.isfinite(res.cameras).all() & torch.isfinite(
                res.points).all()):
        raise AssertionError(f"venice {path}: solved parameters malformed")
    gap = ("" if ref_cost is None else
           f", final cost {abs(c1 - ref_cost) / ref_cost:.3e} relative to "
           "the implicit run's")
    log(f"venice f32 {path}: cost {c0:.8e} -> {c1:.8e}, {res.iterations} LM "
        f"iterations ({res.accepted} accepted), {res.pcg_iterations} PCG "
        f"iterations, flat_solve {wall:.3f} s = {wall / res.iterations:.3f} "
        f"s per LM iteration (planning and transfer included), peak "
        f"memory {peak / 2**30:.3f} GiB, status {res.status}{gap}")
    log(f"venice {path} launches: {counts} (as the code implies)")
    if profile:
        profile_solve(args, path)
    return counts, c1


def profile_solve(args, path: str) -> None:
    """One more venice solve under torch.profiler: device time by kernel
    and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from megba_tpu_torch import flat_solve

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        flat_solve(*args, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    (out_dir / f"profile_venice_{path}.txt").write_text(table)
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in events if e.device_type.name == "CUDA")
    log(f"profile {path}: wall {wall:.3f} s under the profiler, device "
        f"busy {dev_us / 1e6:.3f} s ({dev_us / 1e6 / wall:.1%}); kernel "
        f"table in chiprun_out/profile_venice_{path}.txt")
    log("\n".join(table.splitlines()[:18]))


def main() -> int:
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
    for name, text in kernels.BUILD_LOGS.items():
        print(f"--- nvcc {name}.cu ---\n{text}", file=sys.stderr, flush=True)
    smi = nvidia_smi_line()
    log(smi)

    venice = make_scene(VENICE, np.float32)
    rows = kernel_phase(venice)
    f64_phase(make_scene(TRAFALGAR, np.float64))
    ref_cost = None
    for path, (_, _, kernels_of_path) in PATHS.items():
        counts, cost = venice_phase(venice, path, opts.profile, ref_cost)
        ref_cost = cost if ref_cost is None else ref_cost
        for name in kernels_of_path:  # the first path that runs it
            if rows[name]["launches"] is None:
                rows[name]["launches"] = counts[name]

    log(smi)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
