"""The port's federation tier (megba_tpu_torch/serving/federation.py,
worker.py, artifacts.py) against the JAX package's.

The JAX package's host-side federation tests run here on the port: the
frame RPC, the artifact store's file hardening (fake library bytes
under a private `BUILD_DIR`, the loader replaced: no nvcc), strict
manifests, the pure `RoutingTable`, and the whole router (submit, route,
steal, worker-loss reroute, escalation, sheds, flush) driven through
in-process stub workers; the TCP handle's resend by sequence id and the
worker's dedup cache.  `RoutingTable` decisions and `FederationStats`
are held equal to the JAX package's on the same scripts.  Two tests
start real worker processes on the CPU (`device="cpu"`, f64, one
thread each): two pipe workers warmed from an exported store, bitwise
the port's `solve_many`, and two TCP workers behind `ChaosTcpProxy`
with a seeded drop, bitwise, each problem solved once.
"""

import dataclasses
import json
import os
import socket
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from megba_tpu.serving import federation as jax_federation
from megba_tpu_torch.serving import federation as torch_federation
from megba_tpu_torch.common import (
    AlgoOption,
    Device,
    ProblemOption,
    SolverOption,
    SolveStatus,
)
from megba_tpu_torch.io.synthetic import make_synthetic_bal
from megba_tpu_torch.serving import (
    ArtifactKey,
    ArtifactStore,
    BucketLadder,
    ColdDispatchWarning,
    CompilePool,
    FederationStats,
    FleetProblem,
    FleetResult,
    FleetRouter,
    FleetStats,
    ManifestMismatch,
    RoutingTable,
    WorkerLostError,
    classify,
    solve_many,
)
from megba_tpu_torch.serving import artifacts as artifacts_mod
from megba_tpu_torch.serving.federation import (
    FrameError,
    TcpWorkerHandle,
    WorkerHandle,
    WorkerView,
    append_federation_report,
)
from megba_tpu_torch.serving.resilience import (
    DeadlineExceeded,
    EscalationPolicy,
)
from megba_tpu_torch.serving.transport import (
    PipeTransport,
    ReconnectPolicy,
    TcpTransport,
    heartbeat_frame,
)
from megba_tpu_torch.serving.worker import WorkerRuntime

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.  The worker processes get the same (`ONE_THREAD`).
torch.set_num_threads(1)

OPT64 = ProblemOption(dtype=np.float64, device=Device.CPU,
                      algo_option=AlgoOption(max_iter=6),
                      solver_option=SolverOption(max_iter=12, tol=1e-10))
LADDER = BucketLadder()


def _mk(seed, n_pt, n_cam=4):
    s = make_synthetic_bal(num_cameras=n_cam, num_points=n_pt,
                           obs_per_point=3, seed=seed, param_noise=2e-2,
                           pixel_noise=0.3, dtype=np.float64)
    return FleetProblem.from_synthetic(s, name=f"s{seed}_p{n_pt}")


def _bits(a) -> bytes:
    return np.asarray(a).tobytes()


# ---------------------------------------------------------------------------
# Frame RPC
# ---------------------------------------------------------------------------


def _pipe_channel():
    r1, w1 = os.pipe()
    return (PipeTransport(os.fdopen(r1, "rb", buffering=0),
                         os.fdopen(w1, "wb", buffering=0)))


def test_frame_roundtrip_including_arrays():
    chan = _pipe_channel()
    msg = {"op": "solve", "x": np.arange(1000.0).reshape(10, 100),
           "nested": [1, "two", {"three": np.int32(3)}]}
    chan.send(msg)
    out = chan.recv(timeout_s=5.0)
    assert out["op"] == "solve"
    np.testing.assert_array_equal(out["x"], msg["x"])
    assert out["nested"][2]["three"] == 3
    chan.close()


def test_frame_eof_and_timeout_and_poll_abort():
    # EOF: writer closed with no bytes -> typed FrameError.
    r, w = os.pipe()
    chan = PipeTransport(os.fdopen(r, "rb", buffering=0),
                        os.fdopen(os.dup(w), "wb", buffering=0))
    os.close(w)
    chan._wfile.close()
    with pytest.raises(FrameError):
        chan.recv(timeout_s=5.0)
    # Timeout: open pipe, no frame.
    chan2 = _pipe_channel()
    with pytest.raises(TimeoutError):
        chan2.recv(timeout_s=0.15)
    # Poll abort: the liveness hook's exception propagates.

    class Boom(RuntimeError):
        pass

    def poll():
        raise Boom("dead")

    with pytest.raises(Boom):
        chan2.recv(timeout_s=5.0, poll=poll)
    chan2.close()


def test_frame_truncated_mid_frame_is_typed():
    r, w = os.pipe()
    chan = PipeTransport(os.fdopen(r, "rb", buffering=0),
                        os.fdopen(os.dup(w), "wb", buffering=0))
    import struct

    os.write(w, struct.pack(">Q", 100) + b"only-a-few-bytes")
    os.close(w)
    chan._wfile.close()
    with pytest.raises(FrameError, match="mid-frame"):
        chan.recv(timeout_s=5.0)


# ---------------------------------------------------------------------------
# Artifact store hardening (monkeypatched serializer: zero compiles)
# ---------------------------------------------------------------------------


KEY = ArtifactKey(option_fingerprint="fp", shape="c4_p16_e2048_float64",
                  lanes=2, cd=9, pd=3, od=2)
LIBS = [("segtiles", ()), ("fused", (("MEGBA_ONE_FUSED_CD", 5),
                                     ("MEGBA_ONE_FUSED_PD", 0),
                                     ("MEGBA_ONE_FUSED_OD", 0)))]


@pytest.fixture
def fake_libraries(monkeypatch, tmp_path):
    """Fake built libraries under a private BUILD_DIR, and a loader that
    accepts them: the store's file format, checksum, environment checks
    and installation are testable without nvcc."""
    from megba_tpu_torch.ops import kernels

    build = tmp_path / "build"
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    opened = []
    monkeypatch.setattr(artifacts_mod, "_open_library", opened.append)
    build.mkdir()
    for name, defines in LIBS:
        kernels.library_path(name, defines).write_bytes(
            b"ELF-" + name.encode() + repr(defines).encode())
    return build, opened


def _clear(build):
    for p in build.iterdir():
        p.unlink()


def test_artifact_roundtrip_and_digest(tmp_path, fake_libraries):
    from megba_tpu_torch.ops import kernels

    build, opened = fake_libraries
    store = ArtifactStore(str(tmp_path / "store"))
    assert store.load(KEY) is None  # plain miss: silent
    blobs = {n: kernels.library_path(n, d).read_bytes() for n, d in LIBS}
    path = store.save(KEY, LIBS)
    assert os.path.basename(path) == KEY.filename()
    assert store.entries() == [KEY.filename()]
    _clear(build)  # a fresh replica: nothing built
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a clean load must not warn
        loaded = store.load(KEY)
    assert loaded == [str(kernels.library_path(n, d)) for n, d in LIBS]
    assert opened == loaded
    for n, d in LIBS:  # installed under the digest names, byte for byte
        assert kernels.library_path(n, d).read_bytes() == blobs[n]
    assert not [p for p in build.iterdir() if p.suffix == ".tmp"]
    d1 = store.content_digest(KEY)
    store.save(KEY, LIBS)  # re-export: byte-identical body
    assert store.content_digest(KEY) == d1
    # A CPU bucket's artifact holds no library at all.
    cpu_key = dataclasses.replace(KEY, device="cpu")
    store.save(cpu_key, [])
    assert store.load(cpu_key) == []


def test_artifact_corrupt_truncated_magic_schema(tmp_path, fake_libraries):
    store = ArtifactStore(str(tmp_path))
    path = store.save(KEY, LIBS)
    blob = open(path, "rb").read()

    def expect_warn(data, pattern):
        with open(path, "wb") as fh:
            fh.write(data)
        with pytest.warns(artifacts_mod.ArtifactWarning, match=pattern):
            assert store.load(KEY) is None

    expect_warn(blob[:-7], "checksum mismatch")  # truncated body
    flipped = bytearray(blob)
    flipped[-1] ^= 0xFF
    expect_warn(bytes(flipped), "checksum mismatch")  # corrupt body
    expect_warn(b"NOTMEGBA" + blob[8:], "bad magic")
    expect_warn(blob[:20], "bad magic or truncated")
    # valid container, wrong schema
    import hashlib
    import pickle

    body = pickle.dumps({"schema": "other/v9"})
    digest = hashlib.blake2b(body, digest_size=16).digest()
    expect_warn(b"MEGBAEXE" + digest + body, "unknown artifact schema")


def test_artifact_environment_mismatch_names_fields(tmp_path, fake_libraries,
                                                    monkeypatch):
    from megba_tpu_torch.ops import kernels

    build, _ = fake_libraries
    store = ArtifactStore(str(tmp_path))
    env = artifacts_mod.current_environment()
    with monkeypatch.context() as m:
        m.setattr(artifacts_mod, "current_environment",
                  lambda: dict(env, torch="0.0.1", capability="8.0"))
        store.save(KEY, LIBS)
    with pytest.warns(artifacts_mod.ArtifactWarning,
                      match=r"torch='0\.0\.1'.*capability='8\.0'.*"
                            r"compile-and-refresh"):
        assert store.load(KEY) is None
    # Other kernel sources give the libraries other digest names: the
    # stale artifact is found and refused, naming both fields.
    store.save(KEY, LIBS)
    with monkeypatch.context() as m:
        m.setattr(kernels, "sources_digest", lambda: "0" * 16)
        m.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
        with pytest.warns(artifacts_mod.ArtifactWarning,
                          match=r"nvcc_flags=.*sources=.*libraries="):
            assert store.load(KEY) is None
    # refresh heals: a re-save under the current environment loads again
    store.save(KEY, LIBS)
    assert store.load(KEY) is not None


def test_artifact_loader_refusal_warns(tmp_path, fake_libraries,
                                       monkeypatch):
    from megba_tpu_torch.ops import kernels

    build, _ = fake_libraries
    store = ArtifactStore(str(tmp_path))
    store.save(KEY, LIBS)
    _clear(build)

    def refuse(path):
        raise OSError(f"{path}: invalid ELF header")

    monkeypatch.setattr(artifacts_mod, "_open_library", refuse)
    with pytest.warns(artifacts_mod.ArtifactWarning,
                      match="loader refused"):
        assert store.load(KEY) is None
    # A refused library is not left behind to shadow a build.
    assert not any(kernels.library_path(n, d).exists() for n, d in LIBS)


def test_install_library_is_atomic_and_counted(tmp_path, monkeypatch):
    from megba_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "b")
    before = kernels.nvcc_builds()
    path = kernels.install_library("segsum", (), b"one")
    assert path == kernels.library_path("segsum")
    assert kernels.install_library("segsum", (), b"two").read_bytes() == b"two"
    assert [p.name for p in (tmp_path / "b").iterdir()] == [path.name]
    assert kernels.nvcc_builds() == before  # installing builds nothing


# ---------------------------------------------------------------------------
# Strict manifests
# ---------------------------------------------------------------------------


def test_manifest_strict_mismatch_names_fields(tmp_path):
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn

    engine = make_residual_jacobian_fn(mode=OPT64.jacobian_mode)
    manifest = tmp_path / "m.json"
    CompilePool().save_manifest(str(manifest), option=OPT64)

    # Matching option: strict is a no-op (empty manifest warms nothing).
    assert CompilePool().warm_from_manifest(
        str(manifest), engine, OPT64, strict=True) == 0

    drifted = dataclasses.replace(
        OPT64, algo_option=AlgoOption(max_iter=9))
    with pytest.raises(ManifestMismatch) as exc:
        CompilePool().warm_from_manifest(str(manifest), engine, drifted,
                                         strict=True)
    assert "algo_option.max_iter" in exc.value.fields
    assert "algo_option.max_iter" in str(exc.value)
    # non-strict: the historical warn-and-recompile contract, now
    # naming the fields too
    with pytest.warns(UserWarning, match="algo_option.max_iter"):
        CompilePool().warm_from_manifest(str(manifest), engine, drifted)

    # A telemetry-only difference is NOT a mismatch: sinks never reach
    # a program.
    sink_only = dataclasses.replace(OPT64, telemetry="/tmp/x.jsonl")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert CompilePool().warm_from_manifest(
            str(manifest), engine, sink_only, strict=True) == 0


def test_telemetry_option_shares_keys_and_artifacts(tmp_path):
    """A telemetry-carrying option must warm/export/dispatch under the
    SAME pool keys and artifact fingerprints as its stripped twin —
    sinks never reach a program, so a sink-configured replica must LOAD
    the store a sink-less exporter wrote, not silently recompile it
    (review finding: warm once keyed on the unstripped option)."""
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn
    from megba_tpu_torch.serving.compile_pool import (
        _sans_telemetry,
        pool_key,
    )
    from megba_tpu_torch.serving.shape_class import ShapeClass

    engine = make_residual_jacobian_fn(mode=OPT64.jacobian_mode)
    with_sink = dataclasses.replace(OPT64, telemetry="/tmp/sink.jsonl")
    sc = ShapeClass(n_cam=4, n_pt=16, n_edge=2048, dtype="float64")
    assert (pool_key(engine, OPT64, sc, 1, 9, 3, 2)
            == pool_key(engine, _sans_telemetry(with_sink), sc, 1, 9, 3, 2))

    from megba_tpu_torch.serving.compile_pool import reset_process_cache

    reset_process_cache()
    try:
        store = ArtifactStore(str(tmp_path))
        pool = CompilePool(stats=FleetStats(), artifacts=store)
        store.save(pool._artifact_key(OPT64, sc, 1, 9, 3, 2, False, None),
                   [])
        stats = FleetStats()
        pool2 = CompilePool(stats=stats, artifacts=store)
        assert pool2.warm(engine, with_sink,
                          [{"shape": sc.to_dict(), "lanes": 1}]) == 1
        assert stats.artifact_loads == 1 and stats.artifact_compiles == 0
        # strict manifest round-trip across the sink difference
        m = tmp_path / "m.json"
        pool.save_manifest(str(m), option=with_sink)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            pool2.warm_from_manifest(str(m), engine, OPT64, strict=True)
    finally:
        reset_process_cache()


def test_manifest_without_option_config_still_refuses(tmp_path):
    """Pre-strict manifests carry only the opaque fingerprint: strict
    must still refuse, naming the placeholder."""
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn

    engine = make_residual_jacobian_fn(mode=OPT64.jacobian_mode)
    manifest = tmp_path / "legacy.json"
    CompilePool().save_manifest(str(manifest), option=OPT64)
    doc = json.loads(manifest.read_text())
    del doc["option_config"]
    manifest.write_text(json.dumps(doc))
    drifted = dataclasses.replace(OPT64,
                                  algo_option=AlgoOption(max_iter=9))
    with pytest.raises(ManifestMismatch) as exc:
        CompilePool().warm_from_manifest(str(manifest), engine, drifted,
                                         strict=True)
    assert any("fingerprint" in f for f in exc.value.fields)


# ---------------------------------------------------------------------------
# Routing policy (pure)
# ---------------------------------------------------------------------------


def _views(*specs):
    out = {}
    for wid, warm in specs:
        out[wid] = WorkerView(worker_id=wid, warm=set(warm))
    return out


def test_routing_warm_first_then_least_loaded_then_id():
    t = RoutingTable()
    views = _views(("w0", []), ("w1", ["B1"]), ("w2", []))
    assert t.route("B1", views) == "w1"  # warm-first
    assert t.route("B2", views) in ("w0", "w2")
    assert t.route("B2", views) == "w0"  # deterministic id tiebreak
    assert t.route("B3", views) == "w2"  # least-assigned spreads
    # sticky: B1 stays home even after w1 got loaded
    views["w1"].routed = 100
    assert t.route("B1", views) == "w1"


def test_routing_dead_home_reroutes_and_reassign():
    t = RoutingTable()
    views = _views(("w0", []), ("w1", []))
    assert t.route("B1", views) == "w0"
    views["w0"].alive = False
    orphaned = t.reassign_lost("w0", views)
    assert orphaned == ["B1"]
    assert t.route("B1", views) == "w1"
    # all dead: route returns None
    views["w1"].alive = False
    t2 = RoutingTable()
    assert t2.route("B9", views) is None


def test_steal_candidate_warm_and_deepest_only():
    t = RoutingTable()
    views = _views(("w0", ["B1", "B2"]), ("w1", ["B2"]))
    # both buckets homed on w0 (explicit: the scenario under test is
    # the steal policy, not the assignment path)
    t.assignment.update({"B1": "w0", "B2": "w0"})
    views["w0"].assigned.update({"B1", "B2"})
    depths = {"B1": 5, "B2": 9}
    # w1 is only warm on B2 -> steals B2 even though B1 is listed too
    assert t.steal_candidate("w1", views, depths) == "B2"
    # never steals its own bucket
    t.assignment["B2"] = "w1"
    assert t.steal_candidate("w1", views, depths) is None
    # never steals a bucket it would have to compile
    t.assignment["B2"] = "w0"
    views["w1"].warm.discard("B2")
    assert t.steal_candidate("w1", views, depths) is None
    # a dead victim is not a steal source (reroute handles it)
    views["w1"].warm.add("B2")
    views["w0"].alive = False
    assert t.steal_candidate("w1", views, depths) is None


# ---------------------------------------------------------------------------
# Router end-to-end through stub workers (no subprocess, no compile)
# ---------------------------------------------------------------------------


class StubWorker:
    """In-process stand-in for a worker process: same request surface,
    scripted behavior."""

    def __init__(self, worker_id, warm=(), behavior=None):
        self.worker_id = worker_id
        self.warm = set(warm)
        self.alive = True
        self.pid = 0
        self.behavior = behavior
        self.batches = []  # list of lists of problem names

    def request(self, msg, timeout_s=None):
        if msg.get("op") == "shutdown":
            return {"ok": True}
        problems = msg["problems"]
        self.batches.append([p.name for p in problems])
        if self.behavior is not None:
            return self.behavior(self, problems)
        return {"ok": True, "results": [_stub_result(p) for p in problems],
                "warm": sorted(self.warm)}

    def terminate(self):
        self.alive = False


def _stub_result(p) -> FleetResult:
    sc = classify(*p.dims(), OPT64.dtype, LADDER)
    return FleetResult(
        name=p.name, shape=sc, lane=0, lanes=1,
        cameras=np.asarray(p.cameras).copy(),
        points=np.asarray(p.points).copy(),
        cost=np.float64(1.0), initial_cost=np.float64(2.0),
        iterations=1, accepted=1, pcg_iterations=1,
        status=int(SolveStatus.CONVERGED), recoveries=0, latency_s=0.0)


def _fleet(n, n_pt=16):
    return [_mk(seed, n_pt) for seed in range(n)]


def test_router_routes_resolves_and_counts():
    probs = _fleet(4, n_pt=16) + _fleet(3, n_pt=128)
    w0, w1 = StubWorker("w0"), StubWorker("w1")
    with FleetRouter(OPT64, workers=[w0, w1], max_batch=8) as router:
        futs = [router.submit(p) for p in probs]
        router.flush()
        results = [f.result(timeout=5) for f in futs]
    assert all(r.name == p.name for r, p in zip(results, probs))
    assert all(r.status == int(SolveStatus.CONVERGED) for r in results)
    d = router.stats.as_dict()
    assert d["problems"] == 7
    assert sum(d["problems_by_worker"].values()) == 7
    # two shape classes -> two homes: both workers served
    assert len(d["problems_by_worker"]) == 2
    assert d["workers_lost"] == 0 and d["reroutes"] == 0


def test_router_steal_moves_backlog_to_idle_warm_worker():
    probs = _fleet(8, n_pt=16)
    bucket = str(classify(*probs[0].dims(), OPT64.dtype, LADDER))
    release = threading.Event()

    def blocking(stub, problems):
        # First batch wedges until released: the other worker must pull
        # the backlog rather than wait behind it.
        if len(stub.batches) == 1:
            assert release.wait(timeout=30), "test deadlock"
        return {"ok": True,
                "results": [_stub_result(p) for p in problems],
                "warm": sorted(stub.warm)}

    w0 = StubWorker("w0", warm=[bucket], behavior=blocking)
    w1 = StubWorker("w1", warm=[bucket], behavior=blocking)
    try:
        with FleetRouter(OPT64, workers=[w0, w1], max_batch=4) as router:
            futs = [router.submit(p) for p in probs]
            # both workers take one 4-batch each: one owns the bucket,
            # the other STEALS the backlog it is warm for
            t0 = time.monotonic()
            while (len(w0.batches) + len(w1.batches) < 2
                   and time.monotonic() - t0 < 10):
                time.sleep(0.005)
            release.set()
            router.flush()
            results = [f.result(timeout=10) for f in futs]
    finally:
        release.set()
    assert len(results) == 8
    d = router.stats.as_dict()
    assert d["steals"] == 1, d
    assert d["stolen_problems"] == 4, d
    assert sorted(d["problems_by_worker"].values()) == [4, 4], d


def test_router_worker_loss_reroutes_to_survivor():
    probs = _fleet(6, n_pt=16)

    def dying(stub, problems):
        raise WorkerLostError(stub.worker_id, "stub SIGKILL")

    w0 = StubWorker("w0", behavior=dying)  # id tiebreak homes bucket here
    w1 = StubWorker("w1")  # not warm: cannot steal, only reroute-absorb
    with FleetRouter(OPT64, workers=[w0, w1], max_batch=16,
                     steal=False) as router:
        futs = [router.submit(p) for p in probs]
        router.flush()
        results = [f.result(timeout=10) for f in futs]
        assert len(results) == 6
        d = router.stats.as_dict()
        assert d["workers_lost"] == 1 and d["lost_workers"] == ["w0"]
        assert d["reroutes"] == 6
        assert d["problems_by_worker"] == {"w1": 6}
        # the router keeps serving on the survivor
        fut = router.submit(_mk(99, 16))
        router.flush()
        assert fut.result(timeout=10).name == "s99_p16"


def test_router_all_workers_lost_fails_typed_and_flush_returns():
    def dying(stub, problems):
        raise WorkerLostError(stub.worker_id, "stub death")

    probs = _fleet(5, n_pt=16)
    w0 = StubWorker("w0", behavior=dying)
    w1 = StubWorker("w1", behavior=dying)
    router = FleetRouter(OPT64, workers=[w0, w1], max_batch=4)
    futs = [router.submit(p) for p in probs]
    router.flush()  # must NOT wedge
    for f in futs:
        with pytest.raises(WorkerLostError, match="no surviving workers"):
            f.result(timeout=5)
    with pytest.raises(WorkerLostError, match="no surviving workers"):
        router.submit(_mk(7, 16))
    router.close()
    assert router.stats.as_dict()["workers_lost"] == 2


def test_router_max_reroutes_exhausted_is_typed():
    calls = []

    def dying(stub, problems):
        calls.append(stub.worker_id)
        raise WorkerLostError(stub.worker_id, "stub death")

    probs = _fleet(2, n_pt=16)
    # three workers, max_reroutes=1: initial + 1 reroute both die, the
    # THIRD worker never gets the problems (bounded retry)
    w = [StubWorker(f"w{i}", behavior=dying) for i in range(3)]
    with FleetRouter(OPT64, workers=w, max_batch=4,
                     max_reroutes=1, steal=False) as router:
        futs = [router.submit(p) for p in probs]
        router.flush()
        for f in futs:
            with pytest.raises(WorkerLostError, match="rerouted 1 times"):
                f.result(timeout=5)
    d = router.stats.as_dict()
    assert d["workers_lost"] == 2  # the third never dispatched
    assert d["reroute_failures"] == 2
    assert len(set(calls)) == 2


def test_router_solve_error_fails_batch_but_worker_survives():
    def flaky(stub, problems):
        if len(stub.batches) == 1:
            return {"ok": False, "error": "ValueError('bad operand')"}
        return {"ok": True,
                "results": [_stub_result(p) for p in problems],
                "warm": sorted(stub.warm)}

    w0 = StubWorker("w0", behavior=flaky)
    with FleetRouter(OPT64, workers=[w0], max_batch=4) as router:
        bad = router.submit(_mk(0, 16))
        router.flush()
        with pytest.raises(RuntimeError, match="bad operand"):
            bad.result(timeout=5)
        good = router.submit(_mk(1, 16))
        router.flush()
        assert good.result(timeout=5).name == "s1_p16"
    assert router.stats.as_dict()["workers_lost"] == 0


def test_router_deadline_shed_before_dispatch():
    gate = threading.Event()

    def slow(stub, problems):
        gate.wait(timeout=30)
        return {"ok": True,
                "results": [_stub_result(p) for p in problems],
                "warm": sorted(stub.warm)}

    w0 = StubWorker("w0", behavior=slow)
    try:
        with FleetRouter(OPT64, workers=[w0], max_batch=1) as router:
            first = router.submit(_mk(0, 16))  # occupies the worker
            doomed = router.submit(_mk(1, 16), deadline_s=0.01)
            time.sleep(0.05)
            gate.set()
            router.flush()
            assert first.result(timeout=10) is not None
            with pytest.raises(DeadlineExceeded):
                doomed.result(timeout=5)
    finally:
        gate.set()
    assert router.stats.as_dict()["sheds"] == 1


def test_router_late_completion_flagged_deadline_missed():
    """The FleetQueue parity contract: a result completing AFTER its
    deadline is DELIVERED, flagged and counted — not silently on time
    and not shed (it was dispatched in time)."""
    def slow(stub, problems):
        time.sleep(0.15)
        return {"ok": True,
                "results": [_stub_result(p) for p in problems],
                "warm": sorted(stub.warm)}

    w0 = StubWorker("w0", behavior=slow)
    with FleetRouter(OPT64, workers=[w0], max_batch=4) as router:
        fut = router.submit(_mk(0, 16), deadline_s=0.05)
        router.flush()
        r = fut.result(timeout=5)
    assert r.deadline_missed is True
    d = router.stats.as_dict()
    assert d["deadline_misses"] == 1 and d["sheds"] == 0, d


def test_router_close_idempotent_single_telemetry_line(tmp_path):
    sink = str(tmp_path / "fed.jsonl")
    router = FleetRouter(OPT64, workers=[StubWorker("w0")],
                         telemetry=sink)
    fut = router.submit(_mk(0, 16))
    router.flush()
    assert fut.result(timeout=5) is not None
    router.close()
    router.close()  # explicit double close
    with open(sink) as fh:
        lines = [l for l in fh if l.strip()]
    assert len(lines) == 1, "duplicate federation report on double close"


def test_router_done_callback_may_reenter_router():
    """Shed and worker-lost resolutions run OUTSIDE the router lock: a
    done-callback that re-enters the router (submit from a completion
    hook) must not self-deadlock the serve thread."""
    resubmitted = []

    def dying(stub, problems):
        raise WorkerLostError(stub.worker_id, "stub death")

    w0 = StubWorker("w0", behavior=dying)
    w1 = StubWorker("w1")
    router = FleetRouter(OPT64, workers=[w0, w1], max_batch=4,
                         steal=False, max_reroutes=0)
    fut = router.submit(_mk(0, 16))

    def reenter(f):
        try:
            resubmitted.append(router.submit(_mk(1, 16)))
        except Exception as e:  # noqa: BLE001 - recorded for the assert
            resubmitted.append(e)

    fut.add_done_callback(reenter)
    router.flush()
    with pytest.raises(WorkerLostError):
        fut.result(timeout=5)
    assert len(resubmitted) == 1
    if isinstance(resubmitted[0], Exception):
        raise AssertionError(f"re-entrant submit failed: {resubmitted[0]}")
    router.flush()
    assert resubmitted[0].result(timeout=5) is not None
    router.close()


def test_router_validation():
    with pytest.raises(ValueError, match="n_workers"):
        FleetRouter(OPT64, n_workers=0)
    with pytest.raises(ValueError, match="max_reroutes"):
        FleetRouter(OPT64, workers=[StubWorker("w0")], max_reroutes=-1)
    router = FleetRouter(OPT64, workers=[StubWorker("w0")])
    with pytest.raises(ValueError, match="deadline_s"):
        router.submit(_mk(0, 16), deadline_s=-1.0)
    router.close()
    with pytest.raises(RuntimeError, match="closed"):
        router.submit(_mk(0, 16))


# ---------------------------------------------------------------------------
# Federation observability
# ---------------------------------------------------------------------------


def test_federation_stats_counters_and_report():
    st = FederationStats()
    st.record_batch("w0", 4, stolen=False)
    st.record_batch("w1", 2, stolen=True)
    st.record_reroute(3)
    st.record_worker_lost("w1")
    st.record_cold_start("w0", {"mode": "artifact", "warm_s": 0.42,
                                "artifact_loads": 5,
                                "artifact_compiles": 0})
    st.record_first_solve("w0", {"traces": 0, "wall_s": 0.5})
    d = st.as_dict()
    assert d["problems"] == 6 and d["steals"] == 1
    assert d["stolen_problems"] == 2 and d["reroutes"] == 3
    assert d["workers_lost"] == 1 and d["lost_workers"] == ["w1"]
    text = st.report()
    assert "6 problems" in text and "1 steals" in text
    assert "artifact 0.420s" in text and "first solve 0 traces" in text


def test_summarize_federation_block(tmp_path):
    from megba_tpu_torch.observability import summarize
    from megba_tpu_torch.utils.timing import PhaseTimer

    st = FederationStats()
    st.record_batch("w0", 9, stolen=False)
    st.record_batch("w1", 7, stolen=True)
    st.record_reroute(5)
    st.record_worker_lost("w1")
    st.record_cold_start("w0", {"mode": "artifact", "warm_s": 0.351,
                                "artifact_loads": 5,
                                "artifact_compiles": 0})
    st.record_cold_start("w1", {"mode": "compile", "warm_s": 93.2,
                                "artifact_loads": 0,
                                "artifact_compiles": 5})
    st.record_first_solve("w0", {"traces": 0, "wall_s": 1.0})
    sink = str(tmp_path / "fed.jsonl")
    append_federation_report(OPT64, st, PhaseTimer(), sink)
    # a second (older-router) snapshot must SUM, not duplicate: same
    # router id keeps only the newest line
    append_federation_report(OPT64, st, PhaseTimer(), sink)
    out = summarize.aggregate_paths([sink])
    assert "federation: 16 problems across 2 workers" in out
    assert "w0:9 / w1:7" in out
    assert "1 steals (7 problems)" in out
    assert "5 rerouted, 1 workers lost" in out
    assert "cold start w0: artifact 0.351s (5 loaded / 0 compiled)" in out
    assert "first solve 0 traces" in out
    assert "cold start w1: compile 93.200s (0 loaded / 5 compiled)" in out
    assert summarize.main(["--aggregate", sink]) == 0


def test_solve_report_federation_round_trip():
    from megba_tpu_torch.observability.report import SolveReport

    rep = SolveReport(problem={}, config={}, backend={}, phases={},
                      result={}, federation={"router": "abc",
                                             "problems": 3})
    back = SolveReport.from_json(rep.to_json())
    assert back.federation == {"router": "abc", "problems": 3}
    # pre-federation lines (no field) still parse
    line = json.dumps({"problem": {}, "config": {}, "backend": {},
                       "phases": {}, "result": {}})
    assert SolveReport.from_json(line).federation is None


def test_fleet_stats_artifact_counters():
    st = FleetStats()
    st.record_artifact(True)
    st.record_artifact(True)
    st.record_artifact(False)
    d = st.as_dict()
    assert d["artifact_loads"] == 2 and d["artifact_compiles"] == 1
    assert "artifact store: 2 loaded / 1 compiled" in st.report()


# ---------------------------------------------------------------------------
# Transport supervision (fail-fast, escalation, cold dispatch, reconnect)
# ---------------------------------------------------------------------------


def test_worker_handle_fails_fast_from_recorded_death():
    """Once ONE waiter observes the death, every later request must
    fail from the recorded reason immediately — never re-spend a
    watchdog budget on a channel known dead."""
    r1, w1 = os.pipe()  # router -> worker (never read; stays open)
    r2, w2 = os.pipe()  # worker -> router
    chan = PipeTransport(os.fdopen(r2, "rb", buffering=0),
                        os.fdopen(w1, "wb", buffering=0))
    h = WorkerHandle("w0", None, chan, log_path="/nonexistent")
    os.close(w2)  # worker side gone: the reply read sees EOF
    with pytest.raises(WorkerLostError):
        h.request({"op": "stats"}, timeout_s=5.0)
    t0 = time.monotonic()
    with pytest.raises(WorkerLostError, match="fail-fast"):
        h.request({"op": "stats"}, timeout_s=30.0)
    # Well under the 30s watchdog budget it would otherwise burn.
    assert time.monotonic() - t0 < 1.0
    chan.close()
    os.close(r1)


def test_router_escalation_retries_once_then_succeeds():
    """Past max_reroutes the router consults the EscalationPolicy
    ladder ONCE: the item requeues behind the policy's backoff and a
    survivor serves it instead of failing typed."""
    def dying(stub, problems):
        raise WorkerLostError(stub.worker_id, "stub death")

    w0 = StubWorker("w0", behavior=dying)
    w1 = StubWorker("w1")
    esc = EscalationPolicy(backoff_base_s=0.01)
    with FleetRouter(OPT64, workers=[w0, w1], max_batch=4, steal=False,
                     max_reroutes=0, escalation=esc) as router:
        fut = router.submit(_mk(0, 16))
        router.flush()
        assert fut.result(timeout=10).name == "s0_p16"
    d = router.stats.as_dict()
    assert d["escalations"] == 1, d
    assert d["workers_lost"] == 1 and d["reroute_failures"] == 0, d


def test_router_escalation_consumed_fails_typed():
    """The ladder is consulted once per item: a second loss after the
    escalated retry fails typed, naming the consumed escalation."""
    def dying(stub, problems):
        raise WorkerLostError(stub.worker_id, "stub death")

    workers = [StubWorker(f"w{i}", behavior=dying) for i in range(3)]
    esc = EscalationPolicy(backoff_base_s=0.01)
    with FleetRouter(OPT64, workers=workers, max_batch=4, steal=False,
                     max_reroutes=0, escalation=esc) as router:
        fut = router.submit(_mk(0, 16))
        router.flush()
        with pytest.raises(WorkerLostError, match="escalation consumed"):
            fut.result(timeout=10)
    assert router.stats.as_dict()["escalations"] == 1


def test_router_cold_dispatch_counted_and_warned_once():
    """A dispatch with no warm program on the target counts EVERY
    time but warns ONCE per (bucket, lanes, rung) key."""
    w0 = StubWorker("w0")  # never reports anything warm
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        # max_batch=1 pins every dispatch to lanes=1: one warn key.
        with FleetRouter(OPT64, workers=[w0], max_batch=1) as router:
            for wave in range(2):  # same key twice
                futs = [router.submit(_mk(2 * wave + i, 16))
                        for i in range(2)]
                router.flush()
                for f in futs:
                    assert f.result(timeout=10) is not None
    cold = [w for w in rec if issubclass(w.category, ColdDispatchWarning)]
    assert len(cold) == 1, [str(w.message) for w in rec]
    msg = str(cold[0].message)
    assert "lanes=1" in msg and "rung=0" in msg and "w0" in msg
    assert router.stats.as_dict()["cold_dispatches"] == 4


def test_tcp_handle_reconnect_resends_same_seq():
    """The supervision contract end to end, no sockets faked: a
    scripted server receives the request and DROPS the connection;
    adopting a fresh transport makes the stranded reader resend the
    SAME sequence id and resolve from the second server's reply."""
    events = []

    def on_event(event, worker="?", **kw):
        events.append(event)

    a1, b1 = socket.socketpair()
    h = TcpWorkerHandle(
        "w0", TcpTransport(a1),
        reconnect=ReconnectPolicy(window_s=10.0, base_s=0.01),
        conn_dead_after_s=60.0, on_event=on_event)
    srv1 = TcpTransport(b1)
    got = {}

    def server1():
        got["req1"] = srv1.recv(timeout_s=10.0)
        srv1.close()  # drop mid-request, no reply

    a2, b2 = socket.socketpair()
    srv2 = TcpTransport(b2)

    def server2():
        req = srv2.recv(timeout_s=10.0)
        got["req2"] = req
        srv2.send(heartbeat_frame(1, "w0"))  # skimmed by the reader
        srv2.send({"ok": True, "seq": req["seq"], "answer": 42})

    result = {}

    def do_request():
        result["reply"] = h.request({"op": "stats"}, timeout_s=30.0)

    t1 = threading.Thread(target=server1)
    t1.start()
    rt = threading.Thread(target=do_request)
    rt.start()
    t1.join(timeout=10.0)
    t2 = threading.Thread(target=server2)
    t2.start()
    h.adopt(TcpTransport(a2), incarnation=1)
    rt.join(timeout=10.0)
    t2.join(timeout=10.0)
    assert not rt.is_alive()
    assert result["reply"]["answer"] == 42
    assert got["req1"]["seq"] == got["req2"]["seq"] == result["reply"]["seq"]
    assert "conn_lost" in events and "resend" in events
    # Epoch 1 is the first registration: a connect, not a recovery.
    assert "connect" in events and "reconnect" not in events
    h.terminate()
    srv2.close()


def test_tcp_handle_idle_gap_is_not_connection_loss():
    """last_rx is only refreshed while a reader is listening, so an
    IDLE handle's heartbeats pile up unread and the clock goes stale.
    A request after an idle gap longer than conn_dead_after_s must not
    read that gap as silence: the staleness window starts when the
    reader starts listening (regression: the false conn_lost stranded
    the reader in a reconnect window no healthy worker ever ends)."""
    events = []
    a, b = socket.socketpair()
    h = TcpWorkerHandle(
        "w0", TcpTransport(a), conn_dead_after_s=0.3,
        on_event=lambda event, **kw: events.append(event))
    srv = TcpTransport(b)

    def server():
        req = srv.recv(timeout_s=10.0)
        srv.send({"ok": True, "seq": req["seq"], "answer": 7})

    t = threading.Thread(target=server)
    t.start()
    time.sleep(0.8)  # idle for >2x the staleness threshold
    reply = h.request({"op": "stats"}, timeout_s=10.0)
    t.join(timeout=10.0)
    assert reply["answer"] == 7
    assert "conn_lost" not in events
    h.terminate()
    srv.close()


def test_worker_runtime_dedup_serves_cached_reply(monkeypatch):
    """A resend with an already-answered seq is served from the reply
    cache — counted, never re-executed."""
    # The runtime tags the process env; record-and-restore via
    # monkeypatch so later batcher tests see their own tag.
    monkeypatch.setenv("MEGBA_FEDERATION_WORKER", "test-orig")
    runtime = WorkerRuntime("wdedup", {"option": OPT64})
    r1, w1 = os.pipe()  # router -> worker
    r2, w2 = os.pipe()  # worker -> router
    worker_chan = PipeTransport(os.fdopen(r1, "rb", buffering=0),
                                os.fdopen(w2, "wb", buffering=0))
    router_chan = PipeTransport(os.fdopen(r2, "rb", buffering=0),
                                os.fdopen(w1, "wb", buffering=0))
    t = threading.Thread(target=runtime.serve, args=(worker_chan,))
    t.start()
    try:
        router_chan.send({"op": "stats", "seq": 7})
        first = router_chan.recv(timeout_s=10.0)
        router_chan.send({"op": "stats", "seq": 7})  # resend, same seq
        second = router_chan.recv(timeout_s=10.0)
        assert first["seq"] == second["seq"] == 7
        assert second == first  # the cached reply, bit for bit
        assert runtime.dedup.hit_count() == 1
        assert runtime.timer.counts.get("transport_dedup_hit") == 1
        router_chan.send({"op": "shutdown", "seq": 8})
        assert router_chan.recv(timeout_s=10.0)["ok"]
    finally:
        t.join(timeout=10.0)
        router_chan.close()
        worker_chan.close()
    assert not t.is_alive()




# ---------------------------------------------------------------------------
# The port's policy and counters against the JAX package's
# ---------------------------------------------------------------------------

# Event scripts over three workers: ("route", bucket) | ("steal", thief,
# depths) | ("lost", worker) | ("set", worker, field, value) |
# ("warm", worker, bucket).
ROUTING_SCRIPTS = {
    "spread": [("route", "B1"), ("route", "B2"), ("route", "B3"),
               ("route", "B1"), ("route", "B4"), ("set", "w1", "routed", 9),
               ("route", "B5"), ("route", "B6")],
    "warm_first": [("warm", "w2", "B1"), ("warm", "w1", "B2"),
                   ("route", "B1"), ("route", "B2"), ("route", "B3"),
                   ("warm", "w0", "B2"),
                   ("steal", "w0", {"B1": 3, "B2": 8, "B3": 1}),
                   ("steal", "w2", {"B2": 5}), ("route", "B2")],
    "loss": [("route", "B1"), ("route", "B2"), ("route", "B3"),
             ("set", "w0", "alive", False), ("lost", "w0"),
             ("route", "B1"), ("route", "B4"), ("set", "w1", "alive", False),
             ("lost", "w1"), ("route", "B2"), ("route", "B1")],
    "detour": [("warm", "w1", "B1"), ("warm", "w2", "B1"), ("route", "B1"),
               ("set", "w1", "connected", False), ("route", "B1"),
               ("set", "w2", "connected", False), ("route", "B1"),
               ("route", "B7"), ("set", "w0", "connected", False),
               ("route", "B8"), ("steal", "w0", {"B1": 4})],
}


def _run_routing(mod, script):
    views = {w: mod.WorkerView(worker_id=w, warm=set())
             for w in ("w0", "w1", "w2")}
    table = mod.RoutingTable()
    out = []
    for ev in script:
        if ev[0] == "route":
            out.append(table.route(ev[1], views))
        elif ev[0] == "steal":
            out.append(table.steal_candidate(ev[1], views, dict(ev[2])))
        elif ev[0] == "lost":
            out.append(sorted(table.reassign_lost(ev[1], views)))
        elif ev[0] == "warm":
            views[ev[1]].warm.add(ev[2])
        else:
            setattr(views[ev[1]], ev[2], ev[3])
    return out, dict(table.assignment), {
        w: (sorted(v.assigned), v.routed) for w, v in views.items()}


@pytest.mark.parametrize("script", sorted(ROUTING_SCRIPTS))
def test_routing_decisions_agree_with_jax(script):
    mine = _run_routing(torch_federation, ROUTING_SCRIPTS[script])
    theirs = _run_routing(jax_federation, ROUTING_SCRIPTS[script])
    assert mine == theirs


def _record_stats(st):
    st.record_batch("w0", 16, stolen=False)
    st.record_batch("w1", 5, stolen=True)
    st.record_batch("w0", 3, stolen=True)
    st.record_reroute(4)
    st.record_reroute_failure(2)
    st.record_escalation()
    st.record_cold_dispatch(3)
    st.record_worker_lost("w1")
    st.record_shed(2)
    st.record_deadline_miss()
    st.record_cold_start("w0", {"mode": "artifact", "warm_s": 0.125,
                                "artifact_loads": 4,
                                "artifact_compiles": 0})
    st.record_cold_start("w1", {"mode": "compile", "warm_s": 41.5,
                                "artifact_loads": 0,
                                "artifact_compiles": 4})
    st.record_first_solve("w0", {"traces": 0, "wall_s": 0.5})
    return st


def test_federation_stats_agree_with_jax():
    mine = _record_stats(FederationStats())
    theirs = _record_stats(jax_federation.FederationStats())
    a, b = mine.as_dict(), theirs.as_dict()
    assert a.pop("router") != b.pop("router")  # per-router random ids
    assert a == b
    assert mine.report() == theirs.report()


# ---------------------------------------------------------------------------
# Real worker processes on the CPU
# ---------------------------------------------------------------------------

ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _fleet5():
    return [_mk(i, 16) for i in range(3)] + [_mk(i, 128) for i in range(2)]


def _assert_bitwise(results, control):
    assert len(results) == len(control)
    for r, c in zip(results, control):
        assert r.name == c.name
        assert _bits(r.cameras) == _bits(c.cameras), r.name
        assert _bits(r.points) == _bits(c.points), r.name
        assert _bits(r.cost) == _bits(c.cost), r.name
        assert (int(r.status), r.iterations, r.pcg_iterations) == (
            int(c.status), c.iterations, c.pcg_iterations), r.name


def test_pipe_workers_warm_from_artifacts_bitwise(tmp_path):
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn

    engine = make_residual_jacobian_fn(mode=OPT64.jacobian_mode)
    probs = _fleet5()
    store = ArtifactStore(str(tmp_path / "store"))
    stats = FleetStats()
    pool = CompilePool(stats=stats, artifacts=store)
    control = solve_many(probs, OPT64, pool=pool, stats=stats)
    manifest = str(tmp_path / "manifest.json")
    pool.save_manifest(manifest, option=OPT64)
    assert pool.export_artifacts(engine, OPT64) == len(store.entries()) == 2

    with FleetRouter(OPT64, n_workers=2, artifacts=store.root,
                     manifest=manifest, strict_manifest=True,
                     worker_env=ONE_THREAD) as router:
        futs = router.submit_many(probs)
        router.flush()
        results = [f.result(timeout=60) for f in futs]
        d = router.stats.as_dict()
    _assert_bitwise(results, control)
    assert sorted(d["cold_start"]) == ["w0", "w1"]
    for wid, cs in d["cold_start"].items():
        assert cs["mode"] == "artifact", (wid, cs)
        assert cs["artifact_compiles"] == 0 and cs["artifact_loads"] == 2
        assert cs["nvcc_builds"] == 0, (wid, cs)
        assert os.path.samefile(
            cs["package"], os.path.join(os.path.dirname(__file__), "..",
                                        "megba_tpu_torch"))
    assert d["first_solve"]
    for wid, fs in d["first_solve"].items():
        assert fs["traces"] == 0, (wid, fs)
    assert sum(d["problems_by_worker"].values()) == len(probs)
    assert d["workers_lost"] == 0


# Seed 34 drops the first worker-to-router chunk of connection 0 (a
# worker's register frame) at drop_rate 0.02: one drop whatever the
# timing, and a re-dial.
CHAOS_PLAN = dict(seed=34, drop_rate=0.02)


def test_tcp_workers_behind_chaos_proxy_bitwise_solved_once(tmp_path):
    from megba_tpu_torch.robustness.netfaults import (
        ChaosTcpProxy,
        NetFaultPlan,
    )

    plan = NetFaultPlan(**CHAOS_PLAN)
    assert float(plan.rng(0, 0).random()) < plan.drop_rate
    probs = _fleet5()
    control = solve_many(probs, OPT64)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    with ChaosTcpProxy(f"127.0.0.1:{port}", plan) as proxy:
        with FleetRouter(OPT64, n_workers=2, transport="tcp",
                         bind=f"127.0.0.1:{port}", advertise=proxy.address,
                         token="chaos", worker_env=ONE_THREAD) as router:
            futs = router.submit_many(probs)
            router.flush()
            results = [f.result(timeout=60) for f in futs]
            solved = sum(
                w.request({"op": "stats"}, timeout_s=60.0)["stats"]["problems"]
                for w in router.workers.values())
        counts = proxy.event_counts()
    _assert_bitwise(results, control)
    assert counts.get("drop", 0) >= 1, counts
    assert solved == len(probs)  # every resend served, none solved twice
    assert router.stats.as_dict()["workers_lost"] == 0


def test_worker_refuses_cuda_without_a_card(monkeypatch):
    """A worker's device is its config option's, CUDA by default: without
    a card its hello says so (`ok: False` and the error) and it never
    solves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    monkeypatch.setenv("MEGBA_FEDERATION_WORKER", "test-orig")
    runtime = WorkerRuntime("wcuda", {"option": ProblemOption()})
    hello = runtime.warm()
    assert hello["ok"] is False and hello["worker_id"] == "wcuda"
    assert "no CUDA device is available" in hello["error"]
    reply, stop = runtime.handle({"op": "solve", "problems": [_mk(0, 16)]})
    assert not stop and reply["ok"] is False
    assert "before its warm-up" in reply["error"]


def test_worker_cli_gives_up_after_its_reconnect_budget():
    """`python -m megba_tpu_torch.serving.worker --connect` with no
    router to dial exhausts its reconnect attempts and exits 1."""
    from megba_tpu_torch.serving.worker import main

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    addr = "%s:%d" % probe.getsockname()
    probe.close()  # nothing listens there
    t0 = time.monotonic()
    assert main(["--connect", addr, "--worker-id", "w9",
                 "--reconnect-attempts", "2", "--reconnect-base", "0.01",
                 "--reconnect-cap", "0.02"]) == 1
    assert time.monotonic() - t0 < 10.0
    with pytest.raises(SystemExit):
        main(["--worker-id", "w9"])  # one of --connect / --bind
