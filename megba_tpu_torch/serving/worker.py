"""Federation worker: the serve loop behind every transport, and the
`python -m megba_tpu_torch.serving.worker` bootstrap CLI.

Counterpart of `megba_tpu/serving/worker.py`:

- **`WorkerRuntime`** — the transport-agnostic core: apply one config
  (affinity, telemetry tag, heartbeat board, artifact warm-up), answer
  one request at a time (`solve` / `stats` / `metrics` / `shutdown`)
  and run the serve loop over any `Transport`.  Replies are cached by
  request sequence id (`DedupCache`) before they are sent, so a router
  resend after a reconnect is served from cache and never solved twice.
  The worker's device is the config option's (`ProblemOption.device`,
  CUDA by default): a worker told to run on CUDA in a process without a
  card answers its hello with `ok: False` and the error, and never
  solves on the CPU.

- **The bootstrap CLI** — `--connect HOST:PORT` dials a router and
  `--bind HOST:PORT` listens for one.  Either way the worker speaks
  first: a `register` frame with the token MAC, protocol version,
  environment fingerprint (`serving.artifacts.current_environment`) and
  incarnation; the router answers `config` (first join: the solver
  config over the wire, option and dtype included) or `resume`
  (reconnect: the warmed pool survives), both MAC'd back.  Drift is
  refused typed on either side and is fatal; a dropped connection
  re-dials under `ReconnectPolicy`'s seeded backoff and re-registers
  with the same worker id and `incarnation + 1`.

The hello's `cold_start` block and the first solve's `first_solve` block
keep the JAX package's keys (`mode`, `warm_s`, `artifact_loads`,
`artifact_compiles`, `traces`, `wall_s`).  A bucket program of the port
has nothing to trace; what a cold replica pays is nvcc builds of kernel
libraries, so `traces` counts the nvcc builds this process started
during its first solve (`ops.kernels.nvcc_builds`), and `cold_start`
adds `nvcc_builds` (during the warm-up) and `package` (the directory of
the package the worker imported).

While connected, a beater thread ships `{"__hb__": n}` frames between
replies (the transport's send lock keeps them from interleaving with
reply bytes); the router reads them on its own monotonic clock.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import socket
import sys
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from megba_tpu_torch import observability as _obs
from megba_tpu_torch.serving.transport import (
    DedupCache,
    FrameError,
    HandshakeError,
    ReconnectPolicy,
    TcpTransport,
    Transport,
    heartbeat_frame,
    is_heartbeat,
    parse_address,
    register_frame,
    verify_ack,
)
from megba_tpu_torch.utils.timing import monotonic_s


class WorkerRuntime:
    """One worker's solver state + request handling, transport-free.

    Constructing it applies the config (env tag, CPU affinity, solver
    imports); `warm()` runs the cold start and returns the hello frame;
    `serve(chan)` then answers requests until shutdown (returns 0) or
    connection loss (returns None — the caller owns reconnect policy:
    the pipe worker exits, the TCP worker re-dials)."""

    def __init__(self, worker_id: str, cfg: Dict[str, Any]) -> None:
        self.worker_id = worker_id
        self.cfg = cfg
        # Tag this process's fleet telemetry with the worker id BEFORE
        # any serving import reads it (batcher reads it per report).
        os.environ["MEGBA_FEDERATION_WORKER"] = worker_id
        # CPU pinning (router `pin_cpus=`): restrict this worker to its
        # core slice before the first dispatch, so the threads PyTorch
        # starts later inherit the affinity.
        affinity = cfg.get("cpu_affinity")
        if affinity:
            try:
                os.sched_setaffinity(0, set(int(c) for c in affinity))
            except (AttributeError, OSError):  # non-Linux / restricted
                pass

        from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn
        from megba_tpu_torch.serving.compile_pool import CompilePool
        from megba_tpu_torch.serving.stats import FleetStats
        from megba_tpu_torch.utils.timing import PhaseTimer

        # `option` (observability-STRIPPED: telemetry AND metrics,
        # common.OBSERVABILITY_FIELDS) feeds warmup and fingerprints —
        # the program caches are observability-agnostic by contract;
        # `solve_option` carries this worker's sink AND the config's
        # metrics flag into solve_many, which strips both again before
        # touching any cache, so warm and dispatch agree on keys.
        from megba_tpu_torch.common import strip_observability

        base_option = cfg["option"]
        self.option = strip_observability(base_option)
        self.device = None  # resolved by warm(): no card, no solve
        self.ladder = cfg.get("ladder")
        self.stats = FleetStats()
        self.timer = PhaseTimer()
        self.pool = CompilePool(stats=self.stats,
                                artifacts=cfg.get("artifacts"),
                                timer=self.timer)
        self.engine = make_residual_jacobian_fn(
            mode=self.option.jacobian_mode)
        telemetry = cfg.get("telemetry")
        self.solve_option = dataclasses.replace(
            base_option, telemetry=telemetry or None)
        self.dedup = DedupCache()
        self._first_solve: Optional[Dict[str, Any]] = None

        # File heartbeats: robustness/elastic.py's board, beaten from a daemon
        # thread — the single-host (pipe) shape; TCP fleets beat over
        # the channel instead (files cannot span hosts).
        hb = cfg.get("heartbeat")
        if hb:
            from megba_tpu_torch.robustness.elastic import HeartbeatBoard

            board = HeartbeatBoard(hb["dir"], int(hb["rank"]),
                                   int(hb["world"]))
            interval = float(hb.get("interval_s", 0.25))

            def _beat() -> None:
                while True:
                    board.beat()
                    time.sleep(interval)

            threading.Thread(target=_beat, daemon=True,
                             name="megba-fed-heartbeat").start()

    # -- cold start ------------------------------------------------------
    def warm(self) -> Dict[str, Any]:
        """Warm the manifest's buckets; return the hello frame (`ok`
        False with the error on a warm failure)."""
        from megba_tpu_torch.common import resolve_device
        from megba_tpu_torch.ops import kernels

        t0 = monotonic_s()
        builds0 = kernels.nvcc_builds()
        warmed = 0
        try:
            self.device = resolve_device(None, self.option)
            if self.cfg.get("manifest"):
                warmed = self.pool.warm_from_manifest(
                    self.cfg["manifest"], self.engine, self.option,
                    strict=bool(self.cfg.get("strict_manifest", False)))
        except Exception as exc:
            return {"ok": False, "error": repr(exc),
                    "worker_id": self.worker_id}
        warm_s = monotonic_s() - t0
        loads = self.stats.artifact_loads
        # Store-less warms compile without touching the artifact
        # counters (they describe a store that must exist) — the
        # timer's phase count is the mode signal either way.
        compiles = self.timer.counts.get("warm_compile", 0)
        mode = ("artifact" if loads and not compiles
                else "compile" if compiles else "cold")
        return {
            "ok": True, "op": "hello", "worker_id": self.worker_id,
            "pid": os.getpid(), "warm": self.warm_set(),
            "warmed": warmed,
            "cold_start": {
                "mode": mode, "warm_s": warm_s, "buckets": warmed,
                "artifact_loads": loads, "artifact_compiles": compiles,
                "nvcc_builds": kernels.nvcc_builds() - builds0,
                "package": os.path.dirname(os.path.dirname(
                    os.path.abspath(kernels.__file__))),
                "phases": self.timer.as_dict(),
            },
        }

    def warm_set(self) -> List[str]:
        return sorted({str(_shape_of(e)) for e in self.pool.entries()})

    # -- request handling ------------------------------------------------
    def handle(self, req: Dict[str, Any]) -> Tuple[Dict[str, Any], bool]:
        """Answer one request; returns (reply, stop)."""
        op = req.get("op")
        if op == "shutdown":
            return {"ok": True}, True
        if op == "stats":
            from megba_tpu_torch.ops import fused, segtiles

            # `launches`: this process's kernel launches per wrapper, the
            # proof a router's caller has that the workers ran the kernels.
            return {"ok": True, "stats": self.stats.as_dict(),
                    "phases": self.timer.as_dict(),
                    "launches": {**segtiles.launch_counts(),
                                 **fused.launch_counts()}}, False
        if op == "metrics":
            # Observability harvesting seam: the router merges these
            # per-worker registry snapshots (metrics_snapshot()).
            registry = _obs.metrics_registry()
            return {"ok": True, "metrics": (
                None if registry is None else registry.snapshot())}, False
        if op != "solve":
            return {"ok": False, "error": f"unknown op {op!r}"}, False
        return self._solve(req), False

    def _solve(self, req: Dict[str, Any]) -> Dict[str, Any]:
        from megba_tpu_torch.ops import kernels
        from megba_tpu_torch.serving.batcher import solve_many

        problems = req["problems"]
        recorder = _obs.span_recorder()
        try:
            if self.device is None:
                raise RuntimeError("worker solved before its warm-up")
            base = kernels.nvcc_builds()
            t0 = monotonic_s()
            # The router's trace context rides the solve frame; the
            # worker's whole solve joins it as a child span and the
            # spans recorded under it ship back in the reply.
            scope = (contextlib.nullcontext() if recorder is None
                     else recorder.adopt(
                         "worker_solve", req.get("trace"),
                         worker=self.worker_id,
                         problems=len(problems)))
            with scope:
                results = solve_many(problems, self.solve_option,
                                     ladder=self.ladder, pool=self.pool,
                                     stats=self.stats, timer=self.timer,
                                     device=self.device)
            wall = monotonic_s() - t0
            if self._first_solve is None:
                traces = kernels.nvcc_builds() - base
                self._first_solve = {"traces": int(traces),
                                     "wall_s": wall,
                                     "problems": len(problems)}
            # Traces are per-iteration history — large, and the router's
            # callers read costs, parameters and status; telemetry (the
            # per-problem SolveReports written worker-side) keeps them.
            slim = [dataclasses.replace(r, trace=None) for r in results]
            return {
                "ok": True, "results": slim,
                "warm": self.warm_set(),
                "first_solve": self._first_solve,
                "spans": (None if recorder is None
                          else recorder.drain()),
            }
        except Exception as exc:  # solve failed: typed reply, serve on
            import traceback

            flight = _obs.flight_recorder()
            if flight is not None:
                flight.record("solve_error", worker=self.worker_id,
                              problems=len(problems), error=repr(exc))
            return {"ok": False, "error": repr(exc),
                    "traceback": traceback.format_exc(),
                    "spans": (None if recorder is None
                              else recorder.drain())}

    # -- serve loop ------------------------------------------------------
    def serve(self, chan: Transport) -> Optional[int]:
        """Answer requests until shutdown (-> 0) or connection loss
        (-> None).  Every reply with a sequence id is cached BEFORE it
        is sent: if the send dies mid-frame, the router's resend of the
        same seq is served from cache, never re-executed."""
        while True:
            try:
                req = chan.recv()
            except (FrameError, OSError):
                # FrameError (EOF/desync) or a raw socket error
                # (ECONNRESET): connection gone, caller owns what's
                # next (pipe worker exits, TCP worker re-dials).
                return None
            if is_heartbeat(req):
                continue  # tolerated, though only workers beat today
            seq = req.get("seq") if isinstance(req, dict) else None
            if seq is not None:
                cached = self.dedup.get(seq)
                if cached is not None:
                    self.timer.count_event("transport_dedup_hit")
                    registry = _obs.metrics_registry()
                    if registry is not None:
                        registry.counter(
                            "megba_transport_dedup_total",
                            "Resent requests served from the reply "
                            "cache instead of re-executing").inc(
                                worker=self.worker_id)
                    flight = _obs.flight_recorder()
                    if flight is not None:
                        flight.record("dedup_hit",
                                      worker=self.worker_id, seq=seq)
                    try:
                        chan.send(cached)
                    except OSError:
                        return None
                    continue
            reply, stop = self.handle(req)
            if seq is not None:
                reply = dict(reply)
                reply["seq"] = seq
                self.dedup.put(seq, reply)
            try:
                chan.send(reply)
            except OSError:
                return None
            if stop:
                return 0


def _shape_of(entry: Dict[str, Any]):
    from megba_tpu_torch.serving.shape_class import ShapeClass

    return ShapeClass.from_dict(entry["shape"])


@contextlib.contextmanager
def _crash_flight_dump(worker_id: str):
    """Dump the flight ring when the serve loop dies abnormally (router
    still thinks the worker is alive).  SIGKILL deaths cannot run this
    — the ROUTER's recorder covers those (_on_worker_lost)."""
    try:
        yield
    except BaseException:
        flight = _obs.flight_recorder()
        if flight is not None:
            flight.record("worker_crash", worker=worker_id)
            from megba_tpu_torch.observability import flight as _flight

            _flight.dump_default("worker_crash")
        raise


# ---------------------------------------------------------------------------
# Pipe entry (what a pipe-spawned worker runs)
# ---------------------------------------------------------------------------


def pipe_worker_main() -> int:
    """Run one pipe-spawned worker: frames in on fd 0, frames out on
    the ORIGINAL fd 1; fd 1 is then pointed at stderr so any stray
    print from a library can never corrupt the frame stream."""
    from megba_tpu_torch.serving.transport import PipeTransport

    rpc_in = os.fdopen(os.dup(0), "rb", buffering=0)
    rpc_out = os.fdopen(os.dup(1), "wb", buffering=0)
    os.dup2(2, 1)
    chan = PipeTransport(rpc_in, rpc_out)

    cfg = chan.recv()
    if cfg.get("op") != "config":
        chan.send({"ok": False, "error": f"expected config, got {cfg!r}"})
        return 2
    worker_id = cfg["worker_id"]
    runtime = WorkerRuntime(worker_id, cfg)
    hello = runtime.warm()
    chan.send(hello)
    if not hello.get("ok"):
        return 3
    with _crash_flight_dump(worker_id):
        rc = runtime.serve(chan)
    return 0 if rc is None else rc  # pipe EOF = router gone: clean exit


# ---------------------------------------------------------------------------
# TCP bootstrap CLI
# ---------------------------------------------------------------------------


class _Beater:
    """Per-connection heartbeat thread: `{"__hb__": n}` frames between
    replies.  Stops on `stop()` or the first send failure (the serve
    loop notices the same dead connection on its next recv)."""

    def __init__(self, chan: Transport, worker_id: str,
                 interval_s: float) -> None:
        self._chan = chan
        self._worker_id = worker_id
        self._interval_s = interval_s
        self._stop = threading.Event()
        self._n = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="megba-fed-chan-beat")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            self._n += 1
            try:
                self._chan.send(
                    heartbeat_frame(self._n, self._worker_id))
            except OSError:
                return

    def stop(self) -> None:
        self._stop.set()


def _dial(addr: Tuple[str, int], timeout_s: float) -> socket.socket:
    sock = socket.create_connection(addr, timeout=timeout_s)
    sock.settimeout(None)
    return sock


def run_tcp_worker(
    worker_id: str,
    *,
    connect: Optional[str] = None,
    bind: Optional[str] = None,
    token: Optional[str] = None,
    reconnect: Optional[ReconnectPolicy] = None,
    hb_interval_s: float = 0.25,
    handshake_timeout_s: float = 30.0,
) -> int:
    """Join (and keep rejoining) a router fleet over TCP.

    Returns 0 on a clean router-commanded shutdown, 1 on a typed
    handshake refusal or reconnect-budget exhaustion.  The compile pool
    and dedup cache survive reconnects (the whole point of `resume`);
    only a fresh process starts cold.
    """
    if (connect is None) == (bind is None):
        raise ValueError("exactly one of connect/bind is required")
    policy = reconnect or ReconnectPolicy()
    key = zlib.crc32(worker_id.encode())  # stable per-worker jitter seed

    from megba_tpu_torch.serving.artifacts import current_environment

    env = current_environment()
    runtime: Optional[WorkerRuntime] = None
    incarnation = 0
    attempt = 0
    lsock: Optional[socket.socket] = None
    if bind is not None:
        host, port = parse_address(bind)
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(1)
        print(f"[{worker_id}] listening on "
              f"{lsock.getsockname()[0]}:{lsock.getsockname()[1]}",
              file=sys.stderr, flush=True)

    while True:
        try:
            if lsock is not None:
                sock, peer = lsock.accept()
            else:
                sock = _dial(parse_address(connect), handshake_timeout_s)
        except OSError as exc:
            attempt += 1
            if attempt > policy.max_attempts:
                print(f"[{worker_id}] reconnect budget exhausted "
                      f"({policy.max_attempts} attempts): {exc}",
                      file=sys.stderr, flush=True)
                return 1
            time.sleep(policy.backoff_s(key, attempt))
            continue

        chan = TcpTransport(sock)
        beater: Optional[_Beater] = None
        try:
            chan.send(dict(
                register_frame(worker_id, token, incarnation,
                               os.getpid(), env),
                needs_config=runtime is None))
            ack = chan.recv(timeout_s=handshake_timeout_s)
            op = verify_ack(ack, token, worker_id)
            if op == "config":
                runtime = WorkerRuntime(worker_id, ack["config"])
                chan.send(runtime.warm())
            else:  # resume: warmed pool survives; re-hello with it
                if runtime is None:
                    raise HandshakeError("resume", "no runtime",
                                         "a prior config")
                chan.send({"ok": True, "op": "hello",
                           "worker_id": worker_id, "pid": os.getpid(),
                           "warm": runtime.warm_set(),
                           "resumed": True, "incarnation": incarnation})
        except HandshakeError as exc:
            # Drift refusals are fatal: retrying against a router that
            # will never accept this build only burns the backoff.
            print(f"[{worker_id}] {exc}", file=sys.stderr, flush=True)
            chan.close()
            return 1
        except (FrameError, TimeoutError, OSError) as exc:
            chan.close()
            attempt += 1
            if attempt > policy.max_attempts:
                print(f"[{worker_id}] reconnect budget exhausted "
                      f"({policy.max_attempts} attempts): {exc}",
                      file=sys.stderr, flush=True)
                return 1
            time.sleep(policy.backoff_s(key, attempt))
            continue

        attempt = 0  # registered: the window resets
        beater = _Beater(chan, worker_id, hb_interval_s)
        try:
            with _crash_flight_dump(worker_id):
                rc = runtime.serve(chan)
        finally:
            beater.stop()
            chan.close()
        if rc is not None:
            return rc  # router-commanded shutdown
        incarnation += 1  # connection lost: re-register


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m megba_tpu_torch.serving.worker",
        description="megba federation worker (TCP bootstrap)")
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--connect", metavar="HOST:PORT",
                      help="dial a router at this address")
    mode.add_argument("--bind", metavar="HOST:PORT",
                      help="listen for a router at this address")
    parser.add_argument("--worker-id", required=True,
                        help="stable worker identity (survives restarts)")
    parser.add_argument("--token", default=None,
                        help="shared fleet token (default: "
                             "$MEGBA_FED_TOKEN)")
    parser.add_argument("--hb-interval", type=float, default=0.25,
                        metavar="S", help="channel heartbeat period")
    parser.add_argument("--reconnect-attempts", type=int, default=8)
    parser.add_argument("--reconnect-base", type=float, default=0.05,
                        metavar="S")
    parser.add_argument("--reconnect-cap", type=float, default=2.0,
                        metavar="S")
    parser.add_argument("--reconnect-window", type=float, default=30.0,
                        metavar="S")
    parser.add_argument("--reconnect-jitter", type=float, default=0.5)
    parser.add_argument("--reconnect-seed", type=int, default=0)
    args = parser.parse_args(argv)
    token = (args.token if args.token is not None
             else os.environ.get("MEGBA_FED_TOKEN") or None)
    policy = ReconnectPolicy(
        max_attempts=args.reconnect_attempts,
        base_s=args.reconnect_base, cap_s=args.reconnect_cap,
        window_s=args.reconnect_window, jitter=args.reconnect_jitter,
        seed=args.reconnect_seed)
    try:
        return run_tcp_worker(
            args.worker_id, connect=args.connect, bind=args.bind,
            token=token, reconnect=policy,
            hb_interval_s=args.hb_interval)
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
