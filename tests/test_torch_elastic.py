"""Elastic multi-process solves on the port, on the CPU.

JAX's tests/test_elastic.py (31 cases) on the port: the HeartbeatBoard
and CollectiveWatchdog state machines under injected clocks, the
ElasticMonitor guard with real threads and trivial host functions (the
no-wedge contract), the multihost init / shutdown state machine with
`torch.distributed` monkeypatched where JAX monkeypatched jaxlib, the
schema-v3 snapshot header, the local-devices mesh scope, the N-process
harness driven by stub subprocesses, and the summarize --aggregate
elastic view.  Then, as JAX's tests/test_elastic_killresume.py:

- the shrink arithmetic in one process: world-2 chunks, then
  `resume_elastic` at world 1, within rtol 1e-6 of the uninterrupted
  world-2 run;
- the real kill: two rank processes (this file run as a script is one
  rank) join an elastic gloo world through a rendezvous process bound to
  port 0, and run one world-2 checkpointed solve; rank 1 is SIGKILLed at
  the first world-2 snapshot; rank 0 raises a typed `WorkerLost` within
  `dead_after_s` plus a few polls, resumes at world 1 from the snapshot
  and exits 0, within rtol 1e-6 of the uninterrupted world-2 run (final
  cost and parameters, equal status), with `SolveReport.elastic`
  counting one worker lost, one reshard and one resume.

Every subprocess runs on one intra-op thread under a time limit.  CPU
only.
"""

import os
import sys
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
if __name__ == "__main__":
    sys.path.insert(0, _REPO)

import megba_tpu_torch as mt  # noqa: E402
from megba_tpu_torch.robustness.elastic import (  # noqa: E402
    CollectiveTimeout,
    CollectiveWatchdog,
    ElasticConfig,
    ElasticError,
    ElasticMonitor,
    HeartbeatBoard,
    RankState,
    WorkerLost,
    resume_elastic,
)
from megba_tpu_torch.utils.checkpoint import (  # noqa: E402
    SCHEMA_VERSION,
    load_state,
    save_state,
)

# One intra-op thread (tests and rank processes alike).
torch.set_num_threads(1)

CHECKPOINT_EVERY = 2


def build_problem(world: int):
    """The kill-resume problem, for the ranks and the reference alike:
    tests/test_torch_sharding.py's scene and options, where the world-1
    and world-2 solves agree to ~1e-10.  (JAX's "tiny" problem of
    tests/_elastic_worker.py runs every PCG to its 30-iteration cap at
    tol 1e-12; there the JAX package's own world-1 and world-2
    parameters part by 5.5e-5, past the rtol 1e-6 contract.)"""
    s = mt.make_synthetic_bal(num_cameras=8, num_points=120,
                              obs_per_point=3.5, seed=3)
    option = mt.ProblemOption(
        world_size=world, compute_kind=mt.ComputeKind.IMPLICIT,
        jacobian_mode=mt.JacobianMode.ANALYTICAL,
        algo_option=mt.AlgoOption(max_iter=8, epsilon1=1e-12,
                                  epsilon2=1e-15),
        solver_option=mt.SolverOption(max_iter=30, tol=1e-10,
                                      refuse_ratio=1e30))
    return s, option


def elastic_config(rank: int, world: int, heartbeat_dir: str
                   ) -> ElasticConfig:
    """A dead peer must surface within ~dead_after_s, well inside
    watchdog_s."""
    return ElasticConfig(
        heartbeat_dir=heartbeat_dir, rank=rank, world=world,
        interval_s=0.1, straggler_after_s=0.6, dead_after_s=1.5,
        watchdog_s=30.0, compile_grace_s=120.0, poll_s=0.05)


def _rank(rank: int, port: str, world: int, ckpt: str, out: str,
          hb_dir: str, telemetry: str) -> None:
    """One rank of the elastic world (this file run as a script)."""
    import dataclasses

    from megba_tpu_torch.parallel.multihost import initialize_multihost

    info = initialize_multihost(f"localhost:{port}", world, rank,
                                elastic=True)
    assert info["process_count"] == world, info
    s, option = build_problem(world)
    if telemetry != "-":
        option = dataclasses.replace(option, telemetry=telemetry)
    args = (None, s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    cfg = elastic_config(rank, world, hb_dir)
    detect_kind, latency, detect_at = "none", float("nan"), float("nan")
    with ElasticMonitor(cfg) as monitor:
        try:
            res = mt.solve_checkpointed(
                *args, option, checkpoint_path=ckpt,
                checkpoint_every=CHECKPOINT_EVERY, elastic=monitor,
                device="cpu")
            print(f"rank {rank} CLEAN cost {float(res.cost):.17e}",
                  flush=True)
        except (WorkerLost, CollectiveTimeout) as exc:
            detect_at = time.monotonic()
            detect_kind = ("worker_lost" if isinstance(exc, WorkerLost)
                           else "collective_timeout")
            latency = getattr(exc, "detected_after_s",
                              getattr(exc, "elapsed_s", float("nan")))
            print(f"rank {rank} ELASTIC-DETECT kind={detect_kind} "
                  f"latency={latency:.3f} budget={cfg.watchdog_s:.3f}",
                  flush=True)
            res = resume_elastic(*args, option, ckpt, world_size=1,
                                 monitor=monitor,
                                 checkpoint_every=CHECKPOINT_EVERY,
                                 device="cpu")
            print(f"rank {rank} ELASTIC-RESUME world=1 "
                  f"cost={float(res.cost):.17e} iters={res.iterations} "
                  f"status={res.status}", flush=True)
    if out != "-":
        np.savez(out, cameras=res.cameras.numpy(), points=res.points.numpy(),
                 cost=res.cost.numpy(), iterations=res.iterations,
                 status=res.status, detect_kind=detect_kind,
                 latency=latency, detect_at=detect_at)
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), *sys.argv[4:8])
    raise SystemExit(0)


import json  # noqa: E402
import textwrap  # noqa: E402
import threading  # noqa: E402

import pytest  # noqa: E402


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


# --------------------------------------------------- HeartbeatBoard


def test_board_classifies_alive_straggler_dead(tmp_path):
    clock = FakeClock()
    b0 = HeartbeatBoard(str(tmp_path), 0, 2, straggler_after_s=1.0,
                        dead_after_s=3.0, clock=clock)
    b1 = HeartbeatBoard(str(tmp_path), 1, 2, straggler_after_s=1.0,
                        dead_after_s=3.0, clock=clock)
    b1.beat()
    assert b0.observe() == {1: RankState.ALIVE}
    clock.advance(1.5)  # past straggler, short of dead
    assert b0.observe() == {1: RankState.STRAGGLER}
    b1.beat()  # a fresh beat resurrects the straggler
    assert b0.observe() == {1: RankState.ALIVE}
    clock.advance(3.0)
    assert b0.observe() == {1: RankState.DEAD}
    assert b0.dead_ranks() == [1]
    assert b0.staleness(1) == pytest.approx(3.0)


def test_board_never_seen_rank_unknown_then_dead(tmp_path):
    """A rank that never joins is UNKNOWN inside the join grace
    (anchored at the FIRST observation, not process start), DEAD past
    it — a worker that never came up is as lost as one that died."""
    clock = FakeClock(100.0)
    b0 = HeartbeatBoard(str(tmp_path), 0, 3, straggler_after_s=0.5,
                        dead_after_s=2.0, clock=clock)
    assert b0.observe() == {1: RankState.UNKNOWN, 2: RankState.UNKNOWN}
    clock.advance(1.9)
    assert b0.observe() == {1: RankState.UNKNOWN, 2: RankState.UNKNOWN}
    clock.advance(0.2)
    assert b0.observe() == {1: RankState.DEAD, 2: RankState.DEAD}


def test_board_beat_counter_not_wall_clock(tmp_path):
    """Liveness rides counter CHANGES on the observer's clock — a peer
    whose file content never changes goes stale even though the file
    exists, and cross-process wall clocks are never compared."""
    clock = FakeClock()
    b0 = HeartbeatBoard(str(tmp_path), 0, 2, straggler_after_s=0.5,
                        dead_after_s=1.0, clock=clock)
    with open(b0.path_for(1), "w") as fh:
        fh.write("7 123\n")  # frozen counter
    assert b0.observe() == {1: RankState.ALIVE}
    clock.advance(0.7)
    assert b0.observe() == {1: RankState.STRAGGLER}
    clock.advance(0.5)
    assert b0.observe() == {1: RankState.DEAD}
    # A torn/garbage file reads as "no beat", not a crash.
    with open(b0.path_for(1), "w") as fh:
        fh.write("not-a-counter")
    assert b0.observe() == {1: RankState.DEAD}


def test_board_validates_configuration(tmp_path):
    with pytest.raises(ValueError, match="outside world"):
        HeartbeatBoard(str(tmp_path), 3, 2)
    with pytest.raises(ValueError, match="straggler_after_s"):
        HeartbeatBoard(str(tmp_path), 0, 2, straggler_after_s=5.0,
                       dead_after_s=1.0)


# --------------------------------------------------- CollectiveWatchdog


def test_watchdog_arm_check_disarm_across_dispatches():
    clock = FakeClock()
    w = CollectiveWatchdog(clock=clock)
    t1 = w.arm("chunk@iter0", 10.0, now=0.0)
    assert w.armed_count() == 1
    assert w.check(t1, now=9.0) == pytest.approx(9.0)
    assert w.disarm(t1, now=9.5) == pytest.approx(9.5)
    assert w.armed_count() == 0
    # Re-arming for the next dispatch is a fresh deadline.
    t2 = w.arm("chunk@iter2", 10.0, now=20.0)
    assert w.check(t2, now=29.0) == pytest.approx(9.0)
    w.disarm(t2, now=29.0)
    assert w.timeouts == 0


def test_watchdog_timeout_payload_and_counter():
    w = CollectiveWatchdog(clock=FakeClock())
    tok = w.arm("chunk@iter4", 2.0, now=100.0)
    assert w.expired(now=101.0) == []
    assert w.expired(now=103.0) == [(tok, "chunk@iter4", 3.0)]
    with pytest.raises(CollectiveTimeout) as ei:
        w.check(tok, now=103.0)
    exc = ei.value
    assert exc.label == "chunk@iter4"
    assert exc.budget_s == pytest.approx(2.0)
    assert exc.elapsed_s == pytest.approx(3.0)
    assert isinstance(exc, ElasticError)
    assert w.timeouts == 1
    # The token stays armed: the guard's cleanup still owns the disarm.
    assert w.disarm(tok, now=103.0) == pytest.approx(3.0)
    with pytest.raises(ValueError, match="not armed"):
        w.disarm(tok)


def test_watchdog_rejects_bad_budgets_and_tokens():
    w = CollectiveWatchdog(clock=FakeClock())
    with pytest.raises(ValueError, match="budget_s"):
        w.arm("x", 0.0)
    with pytest.raises(ValueError, match="not armed"):
        w.check(99)


# --------------------------------------------------- ElasticMonitor guard


def _fast_config(tmp_path, world=2, **kw):
    defaults = dict(heartbeat_dir=str(tmp_path / "hb"), rank=0, world=world,
                    interval_s=0.05, straggler_after_s=0.1,
                    dead_after_s=0.25, watchdog_s=5.0,
                    compile_grace_s=0.0, poll_s=0.02)
    defaults.update(kw)
    return ElasticConfig(**defaults)


def test_guard_dead_peer_never_wedges_and_monitor_survives(tmp_path):
    """The no-wedge contract: a dispatch parked forever with a silent
    peer surfaces as a typed WorkerLost within ~dead_after_s — and the
    monitor keeps working afterwards (the abandoned worker thread
    cannot poison the next guard)."""
    with ElasticMonitor(_fast_config(tmp_path)) as m:
        blocker = threading.Event()
        t0 = time.monotonic()
        with pytest.raises(WorkerLost) as ei:
            m.guard("chunk@iter0", blocker.wait)
        elapsed = time.monotonic() - t0
        assert elapsed < 5.0, "typed error took longer than the watchdog"
        assert ei.value.ranks == (1,)
        assert ei.value.label == "chunk@iter0"
        assert ei.value.detected_after_s <= 5.0
        assert m.workers_lost == 1
        assert len(m.detection_s) == 1
        # Monitor (dispatcher side) survives: a later guard still runs.
        assert m.guard("after", lambda: 41 + 1) == 42
        blocker.set()


def test_guard_timeout_with_live_peer_is_collective_timeout(tmp_path):
    """A wedged dispatch while every peer still beats is a
    CollectiveTimeout (straggler semantics), not a WorkerLost."""
    cfg = _fast_config(tmp_path, watchdog_s=0.3, dead_after_s=10.0,
                       straggler_after_s=5.0)
    with ElasticMonitor(cfg) as m:
        peer = HeartbeatBoard(cfg.heartbeat_dir, 1, 2)
        stop = threading.Event()

        def keep_beating():
            while not stop.wait(0.03):
                peer.beat()

        beater = threading.Thread(target=keep_beating, daemon=True)
        peer.beat()
        beater.start()
        try:
            blocker = threading.Event()
            with pytest.raises(CollectiveTimeout) as ei:
                m.guard("chunk@iter2", blocker.wait)
            assert ei.value.budget_s == pytest.approx(0.3)
            assert m.collective_timeouts == 1
            blocker.set()
        finally:
            stop.set()


def test_guard_first_dispatch_compile_grace(tmp_path):
    """The first guarded dispatch of EACH program (grace_key) gets
    watchdog_s + compile_grace_s (jit compilation rides a program's
    first call); repeats of a seen key drop to the bare budget.
    Verified through the watchdog's armed budget — no sleeping."""
    cfg = _fast_config(tmp_path, world=1, watchdog_s=1.0,
                       compile_grace_s=9.0)
    m = ElasticMonitor(cfg)
    budgets = []
    real_arm = m.watchdog.arm

    def spy_arm(label, budget_s, now=None):
        budgets.append(budget_s)
        return real_arm(label, budget_s, now)

    m.watchdog.arm = spy_arm
    assert m.guard("first", lambda: 1) == 1
    assert m.guard("second", lambda: 2) == 2
    assert budgets == [10.0, 1.0]
    # A DIFFERENT program (e.g. a short final chunk, or the 0-iter
    # evaluate dispatch — max_iter is static) gets its own grace.
    assert m.guard("chunk2", lambda: 9, grace_key=("chunk", 2)) == 9
    assert m.guard("chunk2b", lambda: 9, grace_key=("chunk", 2)) == 9
    assert m.guard("evaluate", lambda: 9, grace_key=("chunk", 0)) == 9
    assert budgets == [10.0, 1.0, 10.0, 1.0, 10.0]
    # A reshard re-grants every grace: the shrunk mesh re-lowers all
    # programs.
    m.record_reshard(2, 1)
    assert m.guard("resumed", lambda: 3, grace_key=("chunk", 2)) == 3
    assert budgets == [10.0, 1.0, 10.0, 1.0, 10.0, 10.0]
    m.stop()


def test_guard_classifies_dispatch_error_with_dead_peer(tmp_path):
    """gloo surfaces a SIGKILL'd peer as a transport error within
    milliseconds — before the heartbeat threshold can elapse.  The
    guard must wait out the death window and classify it WorkerLost
    (with the original error as __cause__), not leak a bare
    ValueError."""
    with ElasticMonitor(_fast_config(tmp_path)) as m:
        def exploding_dispatch():
            raise ValueError("Gloo all-reduce failed: connection reset")

        with pytest.raises(WorkerLost) as ei:
            m.guard("chunk@iter0", exploding_dispatch)
        assert isinstance(ei.value.__cause__, ValueError)
        assert m.workers_lost == 1


def test_guard_passes_through_genuine_errors_when_peers_alive(tmp_path):
    """A dispatch exception with every peer beating is the program's
    own failure and must surface unchanged."""
    cfg = _fast_config(tmp_path, dead_after_s=0.2, straggler_after_s=0.1)
    with ElasticMonitor(cfg) as m:
        peer = HeartbeatBoard(cfg.heartbeat_dir, 1, 2)
        stop = threading.Event()

        def keep_beating():
            while not stop.wait(0.03):
                peer.beat()

        beater = threading.Thread(target=keep_beating, daemon=True)
        peer.beat()
        beater.start()
        try:
            with pytest.raises(ZeroDivisionError):
                m.guard("chunk@iter0", lambda: 1 / 0)
            assert m.workers_lost == 0
        finally:
            stop.set()


def test_check_peers_retired_after_reshard(tmp_path):
    """After the reshard the lost peers are retired: liveness checks
    stop raising (the shrunk world no longer contains them)."""
    with ElasticMonitor(_fast_config(tmp_path)) as m:
        m.check_peers()  # anchors rank 1's join grace (UNKNOWN for now)
        time.sleep(0.3)  # nobody ever beats for rank 1: grace expires
        with pytest.raises(WorkerLost):
            m.check_peers()
        m.record_reshard(2, 1)
        m.check_peers()  # no raise
        m.record_reshard(2, 1)  # idempotent per transition
        assert m.reshards == 1
        m.record_resume()
        block = m.report_block()
        assert block["workers_lost"] == 1
        assert block["reshards"] == 1 and block["resumes"] == 1
        assert block["monitor"]
        # Transitions also landed as PhaseTimer events.
        counts = {k: v["calls"] for k, v in m.timer.as_dict().items()}
        assert counts["elastic_worker_lost"] == 1
        assert counts["elastic_reshard"] == 1
        assert counts["elastic_resume"] == 1


def test_monitor_ensure_contract(tmp_path):
    monitor, owned = ElasticMonitor.ensure(None)
    assert monitor is None and owned is False
    cfg = _fast_config(tmp_path, world=1)
    m1, owned = ElasticMonitor.ensure(cfg)
    assert owned is True and m1._beater.is_alive()
    m1.stop()
    m2, owned = ElasticMonitor.ensure(m1)
    assert m2 is m1 and owned is False and m1._beater.is_alive()
    m1.stop()
    with pytest.raises(TypeError, match="ElasticConfig or ElasticMonitor"):
        ElasticMonitor.ensure("nope")


def test_elastic_config_validation(tmp_path):
    with pytest.raises(ValueError, match="outside world"):
        ElasticConfig(heartbeat_dir=str(tmp_path), rank=2, world=2)
    with pytest.raises(ValueError, match="watchdog_s"):
        ElasticConfig(heartbeat_dir=str(tmp_path), watchdog_s=0.0)
    with pytest.raises(ValueError, match="straggler_after_s"):
        ElasticConfig(heartbeat_dir=str(tmp_path), straggler_after_s=9.0,
                      dead_after_s=1.0)


# --------------------------------------------------- multihost state machine


def test_initialize_idempotent_and_reinit_after_shutdown(monkeypatch):
    """The contract: an exact-repeat init is a no-op; other parameters
    while initialized raise; after shutdown_multihost a process may
    initialize again at another world size."""
    from megba_tpu_torch.parallel import multihost as mh

    inits = []
    state = {"up": False, "world": 1}
    monkeypatch.setattr(mh.dist, "is_initialized", lambda: state["up"])
    monkeypatch.setattr(mh, "_make_store",
                        lambda host, port, n, master: (host, port, master))

    def fake_init(store, n, pid):
        inits.append((store, n, pid))
        state.update(up=True, world=n)

    def fake_destroy():
        state["up"] = False

    monkeypatch.setattr(mh, "_init_group", fake_init)
    monkeypatch.setattr(mh.dist, "destroy_process_group", fake_destroy)
    monkeypatch.setattr(mh.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(mh.dist, "get_world_size", lambda: state["world"])
    monkeypatch.setattr(mh.dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(mh, "_local_device_count", lambda: 1)
    monkeypatch.setattr(mh, "_gather_counts",
                        lambda n: [n] * state["world"])
    monkeypatch.setattr(mh, "_initialized_with", None)
    monkeypatch.setattr(mh, "_info", None)

    info = mh.initialize_multihost("localhost:1234", 2, 0, elastic=True)
    assert info["process_count"] == 2 and len(inits) == 1
    # Elastic ranks are rendezvous clients (the store is external).
    assert inits[0][0] == ("localhost", 1234, False)
    # Exact repeat: idempotent, no second bring-up.
    assert mh.initialize_multihost("localhost:1234", 2, 0,
                                   elastic=True) == info
    assert len(inits) == 1
    # Other parameters while initialized: a hard error naming the remedy.
    with pytest.raises(RuntimeError, match="shutdown_multihost"):
        mh.initialize_multihost("localhost:1234", 1, 0, elastic=True)

    # Shutdown (abandon): no collective; re-init at another world size
    # is legal.
    monkeypatch.setattr(mh.dist, "barrier",
                        lambda: pytest.fail("abandon ran a barrier"))
    assert mh.shutdown_multihost(abandon=True) is True
    assert state["up"] is False
    mh.initialize_multihost("localhost:1234", 1, 0, elastic=True)
    assert len(inits) == 2 and inits[-1][1] == 1
    # A plain world's rank 0 hosts the rendezvous.
    state["up"] = False
    monkeypatch.setattr(mh, "_initialized_with", None)
    mh.initialize_multihost("localhost:1234", 2, 0)
    assert inits[-1][0] == ("localhost", 1234, True)


def test_shutdown_not_initialized_is_noop(monkeypatch):
    from megba_tpu_torch.parallel import multihost as mh

    monkeypatch.setattr(mh.dist, "is_initialized", lambda: False)
    assert mh.shutdown_multihost() is False


class _FakeBarrier:
    def __init__(self, block=False):
        self.block = block
        self.started = threading.Event()
        self.calls = 0

    def __call__(self):
        self.started.set()
        self.calls += 1
        if self.block:
            threading.Event().wait()  # never returns (a hung peer)


def _fake_group(monkeypatch, barrier):
    from megba_tpu_torch.parallel import multihost as mh

    state = {"up": True, "destroyed": 0}
    monkeypatch.setattr(mh.dist, "is_initialized", lambda: state["up"])
    monkeypatch.setattr(mh.dist, "barrier", barrier)

    def destroy():
        state["up"] = False
        state["destroyed"] += 1

    monkeypatch.setattr(mh.dist, "destroy_process_group", destroy)
    return mh, state


def test_shutdown_graceful_bounded_when_peer_dead(monkeypatch):
    """The cooperative path never blocks past timeout_s: a barrier
    wedged on a peer is abandoned (daemon thread) and the group is
    destroyed anyway, as with abandon=True."""
    barrier = _FakeBarrier(block=True)
    mh, state = _fake_group(monkeypatch, barrier)
    t0 = time.monotonic()
    assert mh.shutdown_multihost(timeout_s=0.2) is True
    assert time.monotonic() - t0 < 2.0
    assert barrier.started.is_set() and state["destroyed"] == 1


def test_shutdown_graceful_fast_path(monkeypatch):
    """Cooperative teardown: the barrier runs, then the group is
    destroyed by this call itself."""
    barrier = _FakeBarrier()
    mh, state = _fake_group(monkeypatch, barrier)
    assert mh.shutdown_multihost(timeout_s=5.0) is True
    assert barrier.calls == 1
    assert state["destroyed"] == 1 and state["up"] is False


def test_elastic_requires_explicit_rendezvous():
    from megba_tpu_torch.parallel import multihost as mh

    with pytest.raises(ValueError, match="explicit"):
        mh.initialize_multihost(elastic=True)


# --------------------------------------------------- mesh local scope


def test_make_mesh_local_devices_only_scope(monkeypatch):
    from megba_tpu_torch.parallel import mesh as tmesh

    # A process group of two ranks is "up": meshes span processes...
    monkeypatch.setattr(tmesh.torch.distributed, "is_initialized",
                        lambda: True)
    monkeypatch.setattr(tmesh.torch.distributed, "get_world_size",
                        lambda: 2)
    assert not tmesh.local_only_active()
    assert tmesh.multiprocess_active()
    with tmesh.local_devices_only():
        # ...except inside the scope, which builds them from this
        # process's devices.
        assert tmesh.local_only_active()
        with tmesh.local_devices_only():  # re-entrant
            assert tmesh.local_only_active()
        assert tmesh.local_only_active()
        assert not tmesh.multiprocess_active()
        mesh = tmesh.make_mesh(2, ["cpu", "cpu"])
        assert not mesh.is_multiprocess
        assert all(d is not None for d in mesh.devices)
        assert mesh.local_shards == (0, 1) and mesh.home == 0
    assert not tmesh.local_only_active()


# --------------------------------------------------- checkpoint schema v3


def test_snapshot_world_header_roundtrip(tmp_path):
    path = str(tmp_path / "snap.npz")
    save_state(path, np.ones((2, 2)), np.zeros((3,)), region=1.0,
               iteration=4, world_size=8, process_index=3)
    st = load_state(path)
    assert int(st["world_size"]) == 8
    assert int(st["process_index"]) == 3
    assert SCHEMA_VERSION == 3


def test_snapshot_world_mismatch_warns_not_fails(tmp_path):
    path = str(tmp_path / "snap.npz")
    save_state(path, np.ones((2, 2)), np.zeros((3,)), world_size=2)
    with pytest.warns(UserWarning, match="elastic shrink/grow"):
        st = load_state(path, expect_world_size=1)
    assert int(st["world_size"]) == 2  # loaded anyway: the sanctioned path
    # Matching world: silent.
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("error")
        load_state(path, expect_world_size=2)


def test_snapshot_v2_and_legacy_load_unchanged(tmp_path):
    from megba_tpu_torch.utils import checkpoint as ckpt

    # A v2 snapshot (pre-world-header): loads silently even when the
    # caller states an expectation — there is nothing to compare.
    path = str(tmp_path / "v2.npz")
    payload = {"cameras": np.ones((2, 2)), "points": np.zeros((3,)),
               ckpt._SCHEMA_KEY: np.asarray(2)}
    payload[ckpt._CHECKSUM_KEY] = ckpt._digest(payload)
    np.savez(path, **payload)
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("error")
        st = load_state(path, expect_world_size=4)
    assert "world_size" not in st
    # Legacy checksum-free: best-effort pass-through, unchanged.
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, cameras=np.ones((2, 2)), points=np.zeros((3,)))
    st = load_state(legacy, expect_world_size=4)
    np.testing.assert_array_equal(st["cameras"], np.ones((2, 2)))


def test_snapshot_v3_corrupt_truncated_repinned(tmp_path):
    """The corruption contract survives the v3 header: truncation and
    checksum failure still refuse with the same clear errors."""
    path = str(tmp_path / "v3.npz")
    save_state(path, np.ones((4, 4)), np.zeros((5,)), region=2.0,
               iteration=1, world_size=2, process_index=0)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        load_state(path)
    # Valid zip, tampered array: only the content checksum catches it.
    save_state(path, np.ones((4, 4)), np.zeros((5,)), world_size=2)
    with np.load(path) as z:
        st = {k: z[k] for k in z.files}
    st["world_size"] = np.asarray(7)  # tampered header, stale checksum
    np.savez(path, **st)
    with pytest.raises(ValueError, match="checksum"):
        load_state(path)


# --------------------------------------------------- world kill harness


def _stub_worker(body: str) -> list:
    return [sys.executable, "-c", textwrap.dedent(body)]


def test_world_harness_kills_rank_and_collects_survivors(tmp_path):
    from megba_tpu_torch.robustness.harness import run_world_until_snapshot_then_kill

    snap = str(tmp_path / "snap.npz")
    rank0 = _stub_worker(f"""
        import time
        open({snap!r}, "w").write("x" * 64)
        time.sleep(0.8)   # "detect + resume", then exit on its own
        print("rank0 resumed")
    """)
    rank1 = _stub_worker("""
        import time
        time.sleep(300)   # parked in the "collective" until SIGKILLed
    """)
    outcome = run_world_until_snapshot_then_kill(
        [rank0, rank1], snap, kill_rank=1, timeout=30,
        survivor_timeout=30)
    assert outcome.kill_rank == 1
    assert outcome.returncodes[1] == -9  # SIGKILL, nothing graceful
    assert outcome.returncodes[0] == 0
    assert "rank0 resumed" in outcome.outputs[0]


def test_world_harness_flags_wedged_survivor(tmp_path):
    """A survivor that does NOT exit within the grace is the failure
    the harness exists to catch — named, with outputs, not a hang."""
    from megba_tpu_torch.robustness.harness import run_world_until_snapshot_then_kill

    snap = str(tmp_path / "snap.npz")
    rank0 = _stub_worker(f"""
        import time
        open({snap!r}, "w").write("x" * 64)
        time.sleep(300)   # wedged: never exits
    """)
    rank1 = _stub_worker("import time; time.sleep(300)")
    with pytest.raises(TimeoutError, match="wedged past the watchdog"):
        run_world_until_snapshot_then_kill(
            [rank0, rank1], snap, kill_rank=1, timeout=30,
            survivor_timeout=1.0)


def test_world_harness_rejects_early_exit_before_snapshot(tmp_path):
    from megba_tpu_torch.robustness.harness import run_world_until_snapshot_then_kill

    snap = str(tmp_path / "never.npz")
    rank0 = _stub_worker("print('crashed early'); raise SystemExit(3)")
    rank1 = _stub_worker("import time; time.sleep(300)")
    with pytest.raises(AssertionError, match="rank 0 exited"):
        run_world_until_snapshot_then_kill(
            [rank0, rank1], snap, kill_rank=1, timeout=30)


def test_world_harness_validates_kill_rank(tmp_path):
    from megba_tpu_torch.robustness.harness import run_world_until_snapshot_then_kill

    with pytest.raises(ValueError, match="kill_rank"):
        run_world_until_snapshot_then_kill(
            [["true"]], str(tmp_path / "s.npz"), kill_rank=5)


# --------------------------------------------------- summarize elastic view


def _elastic_report_line(monitor_id, created, **counters):
    from megba_tpu_torch.observability.report import SolveReport

    block = {"monitor": monitor_id, "rank": 0, "world": 2,
             "workers_lost": 0, "collective_timeouts": 0, "reshards": 0,
             "resumes": 0, "detection_s": []}
    block.update(counters)
    return SolveReport(
        problem={}, config={}, backend={}, phases={},
        result={"status_name": "converged"}, elastic=block,
        created_unix=created).to_json()


def test_aggregate_renders_elastic_counters(tmp_path):
    """Per-chunk elastic blocks are cumulative snapshots: the aggregate
    must keep the LAST per monitor and sum ACROSS monitors — and render
    the time-to-detection percentiles."""
    from megba_tpu_torch.observability import summarize

    sink = tmp_path / "elastic.jsonl"
    lines = [
        # monitor A: two chunk snapshots, later one supersedes
        _elastic_report_line("aaa", 100.0, workers_lost=1,
                             detection_s=[1.5]),
        _elastic_report_line("aaa", 200.0, workers_lost=1, reshards=1,
                             resumes=1, detection_s=[1.5]),
        # monitor B: a straggler timeout on another rank
        _elastic_report_line("bbb", 150.0, collective_timeouts=2,
                             workers_lost=1, detection_s=[0.5]),
    ]
    sink.write_text("\n".join(lines) + "\n")
    out = summarize.aggregate_paths([str(sink)])
    assert ("elastic: 2 workers lost, 2 collective timeouts, 1 reshards, "
            "1 resumes (2 monitors)") in out
    assert "time-to-detection: p50 0.500s / max 1.500s over 2 losses" in out
    assert summarize.main(["--aggregate", str(sink)]) == 0


def test_report_without_elastic_block_renders_no_elastic_line(tmp_path):
    from megba_tpu_torch.observability import summarize
    from megba_tpu_torch.observability.report import SolveReport

    sink = tmp_path / "plain.jsonl"
    sink.write_text(SolveReport(
        problem={}, config={}, backend={}, phases={},
        result={"status_name": "converged"},
        created_unix=1.0).to_json() + "\n")
    out = summarize.aggregate_paths([str(sink)])
    assert "elastic:" not in out


# --------------------------------------------------- shrink-world resume


def _clean_world2(tmp_path):
    s, option = build_problem(2)
    return s, option, mt.solve_checkpointed(
        None, s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, option,
        checkpoint_path=str(tmp_path / "clean.npz"),
        checkpoint_every=CHECKPOINT_EVERY, device=["cpu"] * 2)


def _within(res, ref):
    assert int(res.status) == int(ref.status)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res.cameras),
                               np.asarray(ref.cameras), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(res.points),
                               np.asarray(ref.points), rtol=1e-6, atol=1e-9)


def test_shrink_world_resume_in_process_parity(tmp_path):
    """The shrink arithmetic without processes: world-2 chunks on two
    CPU shards, stop at the snapshot, resume_elastic at world 1, and
    match the uninterrupted world-2 run."""
    import dataclasses

    s, option, clean = _clean_world2(tmp_path)
    args = (None, s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    ck = str(tmp_path / "elastic.npz")
    short = dataclasses.replace(option, algo_option=dataclasses.replace(
        option.algo_option, max_iter=CHECKPOINT_EVERY))
    mt.solve_checkpointed(*args, short, checkpoint_path=ck,
                          checkpoint_every=CHECKPOINT_EVERY,
                          device=["cpu"] * 2)
    assert int(load_state(ck)["world_size"]) == 2
    res = resume_elastic(*args, option, ck, world_size=1,
                         checkpoint_every=CHECKPOINT_EVERY, device="cpu")
    assert int(load_state(ck)["world_size"]) == 1
    assert int(res.iterations) == int(clean.iterations)
    _within(res, clean)


def test_world2_sigkill_rank1_detect_shrink_resume_parity(tmp_path):
    from megba_tpu_torch.robustness.harness import (
        run_world_until_snapshot_then_kill,
    )

    hb_dir = str(tmp_path / "hb")
    ck0, ck1 = str(tmp_path / "ck.r0.npz"), str(tmp_path / "ck.r1.npz")
    out0 = str(tmp_path / "result.npz")
    sink = str(tmp_path / "telemetry.jsonl")
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    me = os.path.abspath(__file__)

    def workers(line):
        port = line.split()[-1]
        return [[sys.executable, me, "0", port, "2", ck0, out0, hb_dir,
                 sink],
                [sys.executable, me, "1", port, "2", ck1, "-", hb_dir, "-"]]

    rendezvous = [sys.executable, "-m", "megba_tpu_torch.parallel.multihost",
                  "--serve", "0", "2"]
    outcome = run_world_until_snapshot_then_kill(
        [], ck0, kill_rank=1, rendezvous_argv=rendezvous,
        timeout=120.0, survivor_timeout=120.0, env=env,
        worker_argvs_after_rendezvous=workers)

    # Rank 1 died by SIGKILL; rank 0 detected, resumed and exited 0 on
    # its own (the harness's survivor wait is the no-wedge gate).
    assert outcome.returncodes[1] < 0, outcome.outputs[1]
    assert outcome.returncodes[0] == 0, outcome.outputs[0]
    out = outcome.outputs[0]
    assert "ELASTIC-DETECT kind=worker_lost" in out, out
    assert "ELASTIC-RESUME world=1" in out, out
    res = dict(np.load(out0))
    assert str(res["detect_kind"]) == "worker_lost"
    cfg = elastic_config(0, 2, hb_dir)
    # Typed detection within dead_after_s plus a few polls, on the
    # survivor's clock and from the kill.
    assert cfg.dead_after_s <= float(res["latency"]) \
        <= cfg.dead_after_s + 10 * cfg.poll_s
    assert float(res["detect_at"]) - outcome.kill_monotonic \
        <= cfg.dead_after_s + 10 * cfg.poll_s

    # The snapshot chain: written at world 2 before the kill, finished
    # at world 1 after the shrink.
    final = load_state(ck0)
    assert int(final["world_size"]) == 1
    assert int(final["iteration"]) == int(res["iterations"])

    _, _, clean = _clean_world2(tmp_path)

    class _R:
        cost = res["cost"]
        status = res["status"]
        cameras = res["cameras"]
        points = res["points"]

    assert int(res["iterations"]) == int(clean.iterations)
    _within(_R, clean)

    # The terminal telemetry line carries the elastic ledger.
    block = json.loads(open(sink).read().splitlines()[-1])["elastic"]
    assert (block["workers_lost"], block["reshards"],
            block["resumes"]) == (1, 1, 1)
    assert block["rank"] == 0 and block["world"] == 2
