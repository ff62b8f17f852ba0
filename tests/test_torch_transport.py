"""The port's federation transport (megba_tpu_torch/serving/transport.py)
against the JAX package's.

The JAX package's transport tests run here on the port: the frame codec
and its typed failures, partial reads, pipe / TCP byte equivalence, the
register / ack handshake, `ReconnectPolicy` and `DedupCache`.  Then the
two packages are held against each other where both are deterministic:
a frame either encodes decodes in the other, both encode the same numpy
payload to the same bytes, `_mac` and the register frame agree apart
from the environment fingerprint, and `backoff_s` agrees over a grid of
(key, attempt).  No process is spawned and nothing compiles.
"""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from megba_tpu.serving import transport as jax_transport
from megba_tpu_torch.serving import transport as torch_transport
from megba_tpu_torch.serving.transport import (
    HEADER_SIZE,
    MAGIC,
    PROTOCOL_VERSION,
    DedupCache,
    FrameDigestError,
    FrameError,
    FrameLengthError,
    FrameMagicError,
    FrameTruncatedError,
    HandshakeError,
    PipeTransport,
    ReconnectPolicy,
    TcpTransport,
    ack_frame,
    decode_frame,
    encode_frame,
    heartbeat_frame,
    is_heartbeat,
    parse_address,
    refusal_frame,
    register_frame,
    verify_ack,
    verify_register,
)

ENV = {"torch": "2.9", "cuda": "12.8", "device": "cpu", "capability": "none"}


def _tcp_pair():
    a, b = socket.socketpair()
    return TcpTransport(a), TcpTransport(b)


def _pipe():
    r, w = os.pipe()
    return PipeTransport(os.fdopen(r, "rb", buffering=0),
                         os.fdopen(w, "wb", buffering=0))


# ---------------------------------------------------------------------------
# Frame codec
# ---------------------------------------------------------------------------


def test_encode_decode_roundtrip_including_arrays():
    msg = {"op": "solve", "x": np.arange(1000.0).reshape(10, 100),
           "nested": [1, "two", {"three": np.int32(3)}]}
    out = decode_frame(encode_frame(msg))
    np.testing.assert_array_equal(out["x"], msg["x"])
    assert out["nested"][2]["three"] == 3


def test_frame_layout_is_magic_length_digest():
    frame = encode_frame({"a": 1})
    assert frame[:4] == MAGIC
    (length,) = struct.unpack(">Q", frame[4:12])
    assert length == len(frame) - HEADER_SIZE


def test_bad_magic_is_typed_and_names_observed_bytes():
    frame = bytearray(encode_frame({"a": 1}))
    frame[:4] = b"HTTP"
    with pytest.raises(FrameMagicError, match="HTTP"):
        decode_frame(bytes(frame))


def test_oversize_length_bomb_rejected_before_allocation():
    # A corrupted length field must be refused from the HEADER alone —
    # never used as an allocation size.
    header = MAGIC + struct.pack(">Q", 1 << 60) + b"\0" * 16
    with pytest.raises(FrameLengthError, match="1152921504606846976"):
        decode_frame(header)


def test_payload_corruption_is_typed_digest_mismatch():
    frame = bytearray(encode_frame({"a": 1}))
    frame[-1] ^= 0xFF
    with pytest.raises(FrameDigestError):
        decode_frame(bytes(frame))


def test_truncated_payload_names_got_and_need():
    frame = encode_frame({"payload": b"x" * 1000})
    with pytest.raises(FrameTruncatedError) as ei:
        decode_frame(frame[:HEADER_SIZE + 10])
    assert ei.value.got == 10
    assert ei.value.need == len(frame) - HEADER_SIZE


def test_pipe_and_tcp_ship_identical_bytes():
    # The carrier contract: both transports ship exactly encode_frame's
    # bytes, so a frame written by one is readable by the other.
    msg = {"op": "solve", "x": np.arange(32.0)}
    wire = encode_frame(msg)
    r, w = os.pipe()
    chan = PipeTransport(os.fdopen(r, "rb", buffering=0),
                         os.fdopen(w, "wb", buffering=0))
    chan.send(msg)
    assert os.read(r, 1 << 20) == wire
    chan.close()
    a, b = socket.socketpair()
    ta = TcpTransport(a)
    ta.send(msg)
    got = b.recv(1 << 20)
    assert got == wire
    ta.close()
    b.close()


def test_tcp_partial_reads_slow_writer_delivers_whole_frame():
    # Dribble the frame a few bytes at a time from a slow writer
    # thread: recv must assemble it across many partial reads.
    ta, tb = _tcp_pair()
    msg = {"x": np.arange(256.0), "s": "slow"}
    wire = encode_frame(msg)

    def dribble():
        for i in range(0, len(wire), 7):
            ta._sock.sendall(wire[i:i + 7])
            time.sleep(0.001)

    t = threading.Thread(target=dribble)
    t.start()
    out = tb.recv(timeout_s=30.0)
    t.join()
    np.testing.assert_array_equal(out["x"], msg["x"])
    ta.close()
    tb.close()


def test_tcp_mid_frame_eof_is_typed_truncation():
    ta, tb = _tcp_pair()
    wire = encode_frame({"payload": b"y" * 4096})
    ta._sock.sendall(wire[:HEADER_SIZE + 100])
    ta.close()
    with pytest.raises(FrameTruncatedError) as ei:
        tb.recv(timeout_s=5.0)
    assert ei.value.got < ei.value.need
    tb.close()


def test_tcp_mid_header_eof_is_typed_truncation():
    ta, tb = _tcp_pair()
    ta._sock.sendall(encode_frame({"a": 1})[:HEADER_SIZE - 5])
    ta.close()
    with pytest.raises(FrameTruncatedError, match="header"):
        tb.recv(timeout_s=5.0)
    tb.close()


def test_tcp_recv_timeout_and_poll_abort():
    ta, tb = _tcp_pair()
    with pytest.raises(TimeoutError):
        tb.recv(timeout_s=0.15)

    class Boom(RuntimeError):
        pass

    def poll():
        raise Boom("dead")

    with pytest.raises(Boom):
        tb.recv(timeout_s=5.0, poll=poll)
    ta.close()
    tb.close()


def test_desync_garbage_prefix_is_magic_error():
    # A peer speaking another protocol (or a reordered stream) fails
    # typed on the first header, not with an unpickling crash.
    ta, tb = _tcp_pair()
    ta._sock.sendall(b"\x00" * HEADER_SIZE)
    with pytest.raises(FrameMagicError):
        tb.recv(timeout_s=5.0)
    ta.close()
    tb.close()


# ---------------------------------------------------------------------------
# Handshake
# ---------------------------------------------------------------------------


def test_register_verify_roundtrip():
    reg = register_frame("w3", "tok", 2, 123, ENV)
    assert verify_register(reg, "tok", ENV) == "w3"


def test_register_token_refused_before_anything_else():
    # Wrong token must be the FIRST refusal even when other fields
    # drift too — an unauthenticated peer learns nothing else.
    reg = register_frame("w0", "bad", 0, 1, {"torch": "drifted"})
    with pytest.raises(HandshakeError) as ei:
        verify_register(reg, "tok", ENV)
    assert ei.value.field == "token"


def test_register_protocol_drift_typed():
    reg = dict(register_frame("w0", "tok", 0, 1, ENV), protocol=1)
    # The MAC covers the protocol string, so a tampered protocol fails
    # as either token or protocol — both typed.
    with pytest.raises(HandshakeError):
        verify_register(reg, "tok", ENV)


def test_register_env_fingerprint_drift_names_field():
    drifted = dict(ENV, torch="9.9-other")
    reg = register_frame("w0", "tok", 0, 1, drifted)
    with pytest.raises(HandshakeError) as ei:
        verify_register(reg, "tok", ENV)
    assert ei.value.field == "env:torch"
    assert "9.9-other" in str(ei.value)


def test_ack_verify_and_refusal_roundtrip():
    ack = ack_frame("resume", "tok", "w0")
    assert verify_ack(ack, "tok", "w0") == "resume"
    with pytest.raises(HandshakeError):
        verify_ack(ack, "other", "w0")  # router must prove the token too
    with pytest.raises(HandshakeError) as ei:
        verify_ack(refusal_frame(HandshakeError("protocol", 1,
                                                PROTOCOL_VERSION)),
                   "tok", "w0")
    assert ei.value.field == "protocol"


def test_mac_binds_worker_identity():
    # w0's register MAC replayed under w1's id must not verify.
    reg = dict(register_frame("w0", "tok", 0, 1, ENV), worker_id="w1")
    with pytest.raises(HandshakeError) as ei:
        verify_register(reg, "tok", ENV)
    assert ei.value.field == "token"


# ---------------------------------------------------------------------------
# Policies and helpers
# ---------------------------------------------------------------------------


def test_reconnect_policy_deterministic_capped_and_jittered():
    p = ReconnectPolicy(base_s=0.05, factor=2.0, cap_s=2.0, jitter=0.5,
                        seed=3)
    series = [p.backoff_s(7, a) for a in range(1, 9)]
    assert series == [p.backoff_s(7, a) for a in range(1, 9)]  # replay
    assert series != [p.backoff_s(8, a) for a in range(1, 9)]  # per-key
    for a, s in enumerate(series, start=1):
        base = min(0.05 * 2.0 ** (a - 1), 2.0)
        assert base * 0.5 <= s <= base * 1.5
    with pytest.raises(ValueError):
        ReconnectPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        ReconnectPolicy(jitter=1.5)


def test_parse_address():
    assert parse_address("127.0.0.1:80") == ("127.0.0.1", 80)
    assert parse_address("[::1]:8080") == ("::1", 8080)
    with pytest.raises(ValueError):
        parse_address("no-port")
    with pytest.raises(ValueError):
        parse_address("host:notanint")


def test_heartbeat_frames_are_skimmable():
    assert is_heartbeat(heartbeat_frame(3, "w0"))
    assert not is_heartbeat({"op": "solve"})
    assert not is_heartbeat("not-a-dict")


def test_dedup_cache_bounded_fifo_and_hit_count():
    d = DedupCache(capacity=3)
    for seq in range(5):
        assert d.get(seq) is None  # miss before put
        d.put(seq, {"seq": seq})
    assert d.get(0) is None and d.get(1) is None  # evicted, FIFO
    assert d.get(4) == {"seq": 4}
    assert d.get(3) == {"seq": 3}
    assert d.hit_count() == 2


def test_port_environment_fingerprint_names_the_runtime():
    from megba_tpu_torch.serving.artifacts import current_environment

    env = current_environment()
    assert set(env) == {"torch", "cuda", "device", "capability",
                        "nvcc_flags", "sources"}
    assert env["device"] == "cpu" and env["capability"] == "none"
    drifted = dict(env, capability="8.0")
    with pytest.raises(HandshakeError) as ei:
        verify_register(register_frame("w0", "t", 0, 1, drifted), "t", env)
    assert ei.value.field == "env:capability"
    assert "8.0" in str(ei.value)


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

PAYLOADS = [
    {"op": "solve", "x": np.arange(64.0).reshape(8, 8),
     "idx": np.arange(10, dtype=np.int32), "seq": 3},
    {"__hb__": 7, "worker_id": "w1"},
    [1, "two", {"three": np.float32(3.0)}, b"bytes"],
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=["solve", "beat", "nest"])
def test_frames_are_byte_identical_and_cross_decode(payload):
    mine = torch_transport.encode_frame(payload)
    theirs = jax_transport.encode_frame(payload)
    assert mine == theirs
    for frame, decode in ((mine, jax_transport.decode_frame),
                          (theirs, torch_transport.decode_frame)):
        out = decode(frame)
        assert torch_transport.encode_frame(out) == mine


def test_frame_failures_are_typed_alike():
    frame = bytearray(encode_frame({"a": 1}))
    frame[-1] ^= 0xFF
    for mod in (torch_transport, jax_transport):
        with pytest.raises(mod.FrameDigestError) as ei:
            mod.decode_frame(bytes(frame))
        assert "payload corrupted in flight" in str(ei.value)
    with pytest.raises(FrameMagicError) as a:
        decode_frame(b"HTTP" + bytes(frame[4:]))
    with pytest.raises(jax_transport.FrameMagicError) as b:
        jax_transport.decode_frame(b"HTTP" + bytes(frame[4:]))
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("worker_id", ["w0", "w17", "node-a/3"])
def test_mac_and_register_frame_agree_apart_from_env(worker_id):
    for purpose in ("register", "ack:config", "ack:resume"):
        for token in (None, "", "fleet-token"):
            assert (torch_transport._mac(token, purpose, worker_id)
                    == jax_transport._mac(token, purpose, worker_id))
    jenv = {"jax": "0.9.0", "jaxlib": "0.9.0", "backend": "cpu"}
    mine = register_frame(worker_id, "tok", 2, 99, ENV)
    theirs = jax_transport.register_frame(worker_id, "tok", 2, 99, jenv)
    assert mine["env"] == ENV and theirs["env"] == jenv
    assert ({k: v for k, v in mine.items() if k != "env"}
            == {k: v for k, v in theirs.items() if k != "env"})
    # A JAX-package worker registers with a port router up to its
    # fingerprint, which the port refuses, naming the field.
    with pytest.raises(HandshakeError) as ei:
        verify_register(theirs, "tok", ENV)
    assert ei.value.field.startswith("env:")
    assert (ack_frame("config", "tok", worker_id, config={"n": 1})
            == jax_transport.ack_frame("config", "tok", worker_id,
                                       config={"n": 1}))


@pytest.mark.parametrize("seed,jitter", [(0, 0.5), (3, 0.25), (11, 0.0)])
def test_backoff_agrees_over_key_attempt_grid(seed, jitter):
    kw = dict(base_s=0.05, factor=2.0, cap_s=2.0, jitter=jitter, seed=seed)
    mine = ReconnectPolicy(**kw)
    theirs = jax_transport.ReconnectPolicy(**kw)
    grid = [(key, attempt) for key in (0, 1, 7, 2**31 - 1, 123456789)
            for attempt in range(1, 12)]
    assert ([mine.backoff_s(k, a) for k, a in grid]
            == [theirs.backoff_s(k, a) for k, a in grid])


def test_dedup_cache_agrees():
    mine, theirs = DedupCache(capacity=4), jax_transport.DedupCache(capacity=4)
    script = [("put", 1), ("put", 2), ("get", 1), ("put", 3), ("put", 4),
              ("put", 5), ("get", 1), ("get", 2), ("get", 5), ("get", 9)]
    for op, seq in script:
        if op == "put":
            mine.put(seq, {"seq": seq})
            theirs.put(seq, {"seq": seq})
        else:
            assert mine.get(seq) == theirs.get(seq)
    assert mine.hit_count() == theirs.hit_count() == 3
