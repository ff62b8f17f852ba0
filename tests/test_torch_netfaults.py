"""The port's network chaos harness (megba_tpu_torch/robustness/
netfaults.py) against the JAX package's.

The JAX package's netfaults tests run here on the port: a framed echo
upstream behind `ChaosTcpProxy`, a clean plan as a transparent relay,
partition / heal, truncation and drops surfacing as the transport's
typed failures, and the seeded plan's replay.  Then both packages'
`NetFaultPlan` decision streams are held equal for the same seeds.
"""

import socket
import threading

import numpy as np
import pytest

from megba_tpu.robustness import netfaults as jax_netfaults
from megba_tpu_torch.robustness.netfaults import ChaosTcpProxy, NetFaultPlan
from megba_tpu_torch.serving.transport import (
    FrameError,
    TcpTransport,
    parse_address,
)


@pytest.fixture
def echo_upstream():
    """A framed echo server; yields its 'host:port'."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)
    addr = "%s:%d" % srv.getsockname()
    stop = threading.Event()

    def acceptor():
        while not stop.is_set():
            srv.settimeout(0.2)
            try:
                conn, _ = srv.accept()
            except TimeoutError:
                continue
            except OSError:
                return

            def serve(conn=conn):
                chan = TcpTransport(conn)
                try:
                    while True:
                        chan.send({"echo": chan.recv(timeout_s=10.0)})
                except (FrameError, TimeoutError, OSError):
                    chan.close()

            threading.Thread(target=serve, daemon=True).start()

    t = threading.Thread(target=acceptor, daemon=True)
    t.start()
    yield addr
    stop.set()
    srv.close()
    t.join(timeout=5.0)


def _connect(proxy):
    return TcpTransport(
        socket.create_connection(parse_address(proxy.address)))


def test_clean_plan_is_transparent_relay(echo_upstream):
    with ChaosTcpProxy(echo_upstream) as proxy:
        chan = _connect(proxy)
        msg = {"x": np.arange(64.0), "n": 7}
        chan.send(msg)
        out = chan.recv(timeout_s=5.0)
        np.testing.assert_array_equal(out["echo"]["x"], msg["x"])
        assert proxy.event_counts() == {"accept": 1}
        chan.close()


def test_partition_severs_refuses_then_heals(echo_upstream):
    with ChaosTcpProxy(echo_upstream) as proxy:
        chan = _connect(proxy)
        chan.send({"n": 1})
        assert chan.recv(timeout_s=5.0) == {"echo": {"n": 1}}
        proxy.partition()
        # Live connection severed: the next exchange fails typed.
        with pytest.raises((FrameError, OSError, TimeoutError)):
            chan.send({"n": 2})
            chan.recv(timeout_s=2.0)
        # New connections refused (accept-then-close) while partitioned.
        with pytest.raises((FrameError, OSError, TimeoutError)):
            c2 = _connect(proxy)
            c2.send({"n": 3})
            c2.recv(timeout_s=2.0)
        proxy.heal()
        c3 = _connect(proxy)
        c3.send({"n": 4})
        assert c3.recv(timeout_s=5.0) == {"echo": {"n": 4}}
        counts = proxy.event_counts()
        assert counts["partition"] == 1 and counts["heal"] == 1
        assert counts.get("refused", 0) >= 1
        c3.close()
        chan.close()


def test_truncate_fault_surfaces_as_typed_frame_failure(echo_upstream):
    plan = NetFaultPlan(seed=11, truncate_rate=1.0)
    with ChaosTcpProxy(echo_upstream, plan) as proxy:
        chan = _connect(proxy)
        chan.send({"payload": b"z" * 8192})
        # The request is truncated toward the upstream, which then
        # drops the connection — the client observes a typed frame
        # failure (FrameError subclass) or a raw socket error, never
        # garbage unpickling.
        with pytest.raises((FrameError, OSError, TimeoutError)):
            chan.recv(timeout_s=5.0)
        assert proxy.event_counts().get("truncate", 0) >= 1
        chan.close()


def test_drop_fault_kills_connection(echo_upstream):
    plan = NetFaultPlan(seed=5, drop_rate=1.0)
    with ChaosTcpProxy(echo_upstream, plan) as proxy:
        chan = _connect(proxy)
        chan.send({"n": 1})
        with pytest.raises((FrameError, OSError, TimeoutError)):
            chan.recv(timeout_s=5.0)
        assert proxy.event_counts().get("drop", 0) >= 1
        chan.close()


def test_plan_validation_and_seeded_determinism():
    with pytest.raises(ValueError):
        NetFaultPlan(drop_rate=1.5)
    with pytest.raises(ValueError):
        NetFaultPlan(delay_s=-1.0)
    p = NetFaultPlan(seed=7, drop_rate=0.3, truncate_rate=0.1)
    a = [float(p.rng(0, 0).random()) for _ in range(4)]
    b = [float(p.rng(0, 0).random()) for _ in range(4)]
    assert a == b  # same (seed, conn, direction) stream replays
    assert a != [float(p.rng(0, 1).random()) for _ in range(4)]
    assert a != [float(p.rng(1, 0).random()) for _ in range(4)]


@pytest.mark.parametrize("seed", [0, 5, 7, 11, 2024])
def test_decision_streams_agree_with_jax(seed):
    rates = dict(drop_rate=0.1, truncate_rate=0.05, reorder_rate=0.05,
                 delay_rate=0.2, delay_s=0.01)
    mine = NetFaultPlan(seed=seed, **rates)
    theirs = jax_netfaults.NetFaultPlan(seed=seed, **rates)
    assert mine == NetFaultPlan(seed=seed, **rates)
    for conn in range(4):
        for direction in (0, 1):
            a, b = mine.rng(conn, direction), theirs.rng(conn, direction)
            assert ([float(a.random()) for _ in range(32)]
                    == [float(b.random()) for _ in range(32)])
    for bad in (dict(drop_rate=1.5), dict(truncate_rate=-0.1),
                dict(delay_s=-1.0)):
        with pytest.raises(ValueError):
            NetFaultPlan(**bad)
        with pytest.raises(ValueError):
            jax_netfaults.NetFaultPlan(**bad)
