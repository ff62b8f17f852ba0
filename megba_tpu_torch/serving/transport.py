"""Federation transport: integrity-checked frames over pipes or TCP.

Counterpart of `megba_tpu/serving/transport.py`, with the same frame
bytes, field names and message texts, so a frame either package encodes
decodes in the other:

- **One frame format, two carriers.**  Every frame is
  `magic(4) | payload_length(>Q, 8) | blake2b-128 digest(16) | payload`
  (a pickle).  `PipeTransport` runs it over a (read file, write file)
  pair, `TcpTransport` over a socket; `encode_frame` is shared, so a
  frame captured off a pipe is byte-identical to the one a socket
  carries.

- **Typed integrity failures.**  Each header field fails its own way,
  naming observed and expected bytes: `FrameMagicError` (desync or a
  foreign peer), `FrameLengthError` (a corrupted length, refused before
  any allocation), `FrameDigestError` (payload corruption; the payload
  is never unpickled), `FrameTruncatedError` (the connection cut
  mid-frame, with byte counts).  All subclass `FrameError`.

- **Supervision policy and handshake.**  `ReconnectPolicy` is the
  capped exponential backoff a dropped connection gets before it counts
  as a worker loss, with deterministic seeded jitter.  The
  register / ack handshake authenticates both directions with an HMAC
  over a shared token and refuses protocol or environment-fingerprint
  drift typed (`HandshakeError` names the field, observed, expected).
  The port's fingerprint (`serving.artifacts.current_environment`)
  names its runtime: the torch version, the CUDA runtime, the device's
  name and compute capability, the nvcc flags and the kernel sources'
  digest; a worker built against another must be refused at the door,
  not found out as a bitwise mismatch later.

- **Idempotent resends.**  `DedupCache` is the worker-side reply cache
  keyed by the request's sequence id: a router that resends after a
  reconnect gets the cached reply, so a retry never solves twice.

Trust model: the token gates fleet membership, not payload safety —
frames are pickle, so the fabric is for trusted networks (loopback, a
private cluster subnet).  Deadlines use `utils.timing.monotonic_s`, the
clock the supervision state machine reads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import os
import pickle
import select
import socket
import struct
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from megba_tpu_torch.utils.timing import monotonic_s

MAGIC = b"MGB2"
_LEN = struct.Struct(">Q")
_DIGEST_SIZE = 16
HEADER_SIZE = len(MAGIC) + _LEN.size + _DIGEST_SIZE
_MAX_FRAME = 1 << 34  # 16 GiB: a corrupted length header fails fast

#: Bumped whenever the frame format or the RPC op vocabulary changes
#: incompatibly; the handshake refuses a mismatch typed.
PROTOCOL_VERSION = 2

#: Key of the heartbeat frames that ride the channel between replies.
HEARTBEAT_KEY = "__hb__"


class FrameError(ConnectionError):
    """The RPC stream ended or produced a malformed frame."""


class FrameMagicError(FrameError):
    """Frame header does not start with the protocol magic: the stream
    desynchronised, or the peer is not a megba federation endpoint."""

    def __init__(self, observed: bytes) -> None:
        self.observed = bytes(observed)
        self.expected = MAGIC
        super().__init__(
            f"bad frame magic: observed {self.observed!r}, expected "
            f"{MAGIC!r} (stream desync or non-protocol peer)")


class FrameLengthError(FrameError):
    """Declared payload length exceeds the sanity cap — a corrupted
    header must fail fast, not allocate gigabytes."""

    def __init__(self, length: int) -> None:
        self.length = int(length)
        self.cap = _MAX_FRAME
        super().__init__(
            f"frame length {self.length} exceeds sanity cap "
            f"{_MAX_FRAME} (corrupted header / length bomb)")


class FrameDigestError(FrameError):
    """Payload bytes do not match the header digest: corruption in
    flight; the payload is never unpickled."""

    def __init__(self, observed: str, expected: str) -> None:
        self.observed = observed
        self.expected = expected
        super().__init__(
            f"frame digest mismatch: payload hashed to {observed}, "
            f"header declared {expected} (payload corrupted in flight)")


class FrameTruncatedError(FrameError):
    """The stream closed with a partial frame in the buffer."""

    def __init__(self, got: int, need: int, where: str) -> None:
        self.got = int(got)
        self.need = int(need)
        super().__init__(
            f"stream closed mid-frame ({where}): got {self.got} of "
            f"{self.need} bytes")


def encode_frame(obj: Any) -> bytes:
    """Serialize one object to its on-wire frame bytes (carrier
    independent: pipes and sockets ship exactly these bytes)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    digest = hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).digest()
    return MAGIC + _LEN.pack(len(payload)) + digest + payload


def check_header(header: bytes) -> Tuple[int, bytes]:
    """Validate a 28-byte frame header; return (payload_len, digest)."""
    if len(header) != HEADER_SIZE:
        raise FrameTruncatedError(len(header), HEADER_SIZE, "header")
    if header[:len(MAGIC)] != MAGIC:
        raise FrameMagicError(header[:len(MAGIC)])
    (length,) = _LEN.unpack(header[len(MAGIC):len(MAGIC) + _LEN.size])
    if length > _MAX_FRAME:
        raise FrameLengthError(length)
    return int(length), header[len(MAGIC) + _LEN.size:]


def check_payload(payload: bytes, digest: bytes) -> Any:
    """Verify payload bytes against the header digest, then unpickle."""
    observed = hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).digest()
    if observed != digest:
        raise FrameDigestError(observed.hex(), digest.hex())
    return pickle.loads(payload)


def decode_frame(data: bytes) -> Any:
    """Decode one complete frame from raw bytes (the codec tests' and
    forensic tooling's entry; transports stream instead)."""
    length, digest = check_header(data[:HEADER_SIZE])
    body = data[HEADER_SIZE:]
    if len(body) < length:
        raise FrameTruncatedError(len(body), length, "payload")
    return check_payload(body[:length], digest)


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class Transport:
    """One duplex frame stream: `send(obj)` / `recv() -> obj` / `close`.

    `recv` reads the UNDERLYING fd directly (private buffer, never a
    BufferedReader) so the select-based timeout/poll path can never
    stall on bytes hidden in a Python-level buffer.  `poll` is called
    between read slices and may raise to abort the wait (the router's
    liveness hook).  ONE deadline spans header + body: a peer stalling
    between the two must not double the effective watchdog budget.

    Sends are serialized under an internal lock so a heartbeat thread
    and a request sender can share the channel without interleaving
    frame bytes; the lock is never held across any blocking read.
    """

    def __init__(self) -> None:
        self._buf = bytearray()
        self._slice_s = 0.05
        self._send_lock = threading.Lock()

    # -- carrier hooks (subclass responsibility) ------------------------
    def _read_fd(self) -> int:
        raise NotImplementedError

    def _read_chunk(self) -> bytes:
        """Read up to ~1 MiB; b'' means EOF.  Only called readable."""
        raise NotImplementedError

    def _write_bytes(self, data: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    # -- frame API -------------------------------------------------------
    def send(self, obj: Any) -> None:
        frame = encode_frame(obj)
        with self._send_lock:
            self._write_bytes(frame)

    def _fill(self, need: int, deadline: Optional[float],
              poll: Optional[Callable[[], None]], where: str) -> None:
        while len(self._buf) < need:
            if poll is not None:
                poll()
            if deadline is not None and monotonic_s() > deadline:
                raise TimeoutError("no complete frame within the budget")
            ready, _, _ = select.select([self._read_fd()], [], [],
                                        self._slice_s)
            if not ready:
                continue
            try:
                chunk = self._read_chunk()
            except BlockingIOError:  # spurious readability
                continue
            if not chunk:
                if self._buf:
                    raise FrameTruncatedError(len(self._buf), need, where)
                raise FrameError("stream closed")
            self._buf.extend(chunk)

    def recv(self, timeout_s: Optional[float] = None,
             poll: Optional[Callable[[], None]] = None) -> Any:
        deadline = None if timeout_s is None else (
            monotonic_s() + timeout_s)
        self._fill(HEADER_SIZE, deadline, poll, "header")
        length, digest = check_header(bytes(self._buf[:HEADER_SIZE]))
        del self._buf[:HEADER_SIZE]
        self._fill(length, deadline, poll, "payload")
        body = bytes(self._buf[:length])
        del self._buf[:length]
        return check_payload(body, digest)


class PipeTransport(Transport):
    """Frame stream over a (read file, write file) pair (a pipe worker's
    stdin / stdout), the JAX package's `FrameChannel`."""

    def __init__(self, rfile, wfile) -> None:
        super().__init__()
        self._rfd = rfile.fileno()
        self._rfile = rfile  # owned: kept for close()
        self._wfile = wfile

    def _read_fd(self) -> int:
        return self._rfd

    def _read_chunk(self) -> bytes:
        return os.read(self._rfd, 1 << 20)

    def _write_bytes(self, data: bytes) -> None:
        self._wfile.write(data)
        self._wfile.flush()

    def close(self) -> None:
        for f in (self._rfile, self._wfile):
            try:
                f.close()
            except OSError:
                pass


class TcpTransport(Transport):
    """Frame stream over a connected TCP socket.

    `TCP_NODELAY` is set: frames are request/response units, and a
    40 ms Nagle stall on every small control frame would dominate
    heartbeat and handshake latency.
    """

    def __init__(self, sock: socket.socket) -> None:
        super().__init__()
        self._sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not a TCP socket (socketpair in tests)
        # Bound sendall: a partitioned peer that stops ACKing would
        # otherwise block a send forever WHILE the sender holds its
        # request lock.  30s is past any healthy send; the resulting
        # socket.timeout is an OSError, i.e. the normal send-failure
        # path (reads never hit it — they recv only after select says
        # readable).
        sock.settimeout(30.0)
        self._closed = False

    def _read_fd(self) -> int:
        return self._sock.fileno()

    def _read_chunk(self) -> bytes:
        return self._sock.recv(1 << 20)

    def _write_bytes(self, data: bytes) -> None:
        self._sock.sendall(data)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def parse_address(addr: str) -> Tuple[str, int]:
    """'host:port' (or '[v6addr]:port') -> (host, port), typed on
    malformed input."""
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        raise ValueError(f"address must be 'host:port', got {addr!r}")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    try:
        return host, int(port)
    except ValueError:
        raise ValueError(
            f"address port must be an integer, got {addr!r}") from None


# ---------------------------------------------------------------------------
# Reconnect policy (the escalation ladder's backoff, applied to connections)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReconnectPolicy:
    """Capped-exponential-backoff reconnect window for a dropped
    connection.

    A connection loss is NOT a worker loss: the worker process may be
    fine behind a flapping link.  The dropped side retries with backoff
    `min(base_s * factor**(attempt-1), cap_s)`, jittered by a
    DETERMINISTIC factor in [1-jitter, 1+jitter] seeded from
    (`seed`, connection key, attempt) — reconnect storms across a fleet
    de-synchronise, yet a fixed seed replays the exact schedule (the
    `EscalationPolicy.backoff_s` stance).  `window_s` bounds the whole
    window on the SUPERVISOR's clock: only its exhaustion (or process
    death) converts the connection loss into a `WorkerLostError`.
    """

    max_attempts: int = 8
    base_s: float = 0.05
    factor: float = 2.0
    cap_s: float = 2.0
    jitter: float = 0.5
    window_s: float = 30.0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_s < 0:
            raise ValueError("base_s must be >= 0")
        if self.factor < 1.0:
            raise ValueError("factor must be >= 1")
        if self.cap_s < self.base_s:
            raise ValueError("cap_s must be >= base_s")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(
                f"jitter must be in [0, 1), got {self.jitter}")
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")

    def backoff_s(self, key: int, attempt: int) -> float:
        """Deterministic-jittered backoff before reconnect `attempt`
        (>= 1) of connection `key` (e.g. a worker rank)."""
        if attempt < 1:
            raise ValueError(f"attempt must be >= 1, got {attempt}")
        base = min(self.base_s * self.factor ** (attempt - 1), self.cap_s)
        if self.jitter == 0.0 or base == 0.0:
            return base
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(key), int(attempt)]))
        factor = 1.0 + self.jitter * (2.0 * float(rng.random()) - 1.0)
        return base * factor


# ---------------------------------------------------------------------------
# Registration handshake
# ---------------------------------------------------------------------------


class HandshakeError(ConnectionError):
    """Registration refused: the peer drifted on `field` (token,
    protocol version, or an environment-fingerprint component)."""

    def __init__(self, field: str, observed: Any, expected: Any) -> None:
        self.field = field
        self.observed = observed
        self.expected = expected
        super().__init__(
            f"federation handshake refused: {field} drift "
            f"(observed {observed!r}, expected {expected!r})")


def _mac(token: Optional[str], purpose: str, worker_id: str) -> str:
    key = (token or "").encode()
    msg = f"megba-fed-v{PROTOCOL_VERSION}:{purpose}:{worker_id}".encode()
    return hmac.new(key, msg, hashlib.blake2b).hexdigest()


def register_frame(worker_id: str, token: Optional[str],
                   incarnation: int, pid: int,
                   env: Dict[str, str]) -> Dict[str, Any]:
    """The worker's first frame on any (re)connection."""
    return {
        "op": "register",
        "worker_id": worker_id,
        "protocol": PROTOCOL_VERSION,
        "mac": _mac(token, "register", worker_id),
        "incarnation": int(incarnation),
        "pid": int(pid),
        "env": dict(env),
    }


def verify_register(reg: Dict[str, Any], token: Optional[str],
                    env: Dict[str, str]) -> str:
    """Validate a register frame against this router's expectations;
    returns the worker id, or raises `HandshakeError` naming the
    drifted field.  Token first: an unauthenticated peer learns nothing
    about our protocol or environment from the refusal."""
    if not isinstance(reg, dict) or reg.get("op") != "register":
        raise HandshakeError("op", (reg or {}).get("op")
                             if isinstance(reg, dict) else type(reg),
                             "register")
    wid = str(reg.get("worker_id", ""))
    if not wid:
        raise HandshakeError("worker_id", reg.get("worker_id"),
                             "a non-empty id")
    expected_mac = _mac(token, "register", wid)
    if not hmac.compare_digest(str(reg.get("mac", "")), expected_mac):
        raise HandshakeError("token", "<mac mismatch>", "<shared token>")
    if reg.get("protocol") != PROTOCOL_VERSION:
        raise HandshakeError("protocol", reg.get("protocol"),
                             PROTOCOL_VERSION)
    peer_env = reg.get("env") or {}
    for field in sorted(set(env) | set(peer_env)):
        if peer_env.get(field) != env.get(field):
            raise HandshakeError(f"env:{field}", peer_env.get(field),
                                 env.get(field))
    return wid


def ack_frame(op: str, token: Optional[str], worker_id: str,
              **extra: Any) -> Dict[str, Any]:
    """Router's reply to a register: `config` (first join) or `resume`
    (reconnect), MAC'd so the worker can verify the router too."""
    out = {"op": op, "mac": _mac(token, f"ack:{op}", worker_id)}
    out.update(extra)
    return out


def verify_ack(ack: Dict[str, Any], token: Optional[str],
               worker_id: str) -> str:
    """Worker-side check of the router's ack; returns the ack op."""
    if not isinstance(ack, dict):
        raise HandshakeError("ack", type(ack), "a dict frame")
    op = ack.get("op")
    if op == "refused":
        raise HandshakeError(str(ack.get("field", "?")),
                             ack.get("observed"), ack.get("expected"))
    if op not in ("config", "resume"):
        raise HandshakeError("ack-op", op, "config|resume")
    expected_mac = _mac(token, f"ack:{op}", worker_id)
    if not hmac.compare_digest(str(ack.get("mac", "")), expected_mac):
        raise HandshakeError("router-token", "<mac mismatch>",
                             "<shared token>")
    return str(op)


def refusal_frame(exc: HandshakeError) -> Dict[str, Any]:
    return {"op": "refused", "field": exc.field,
            "observed": exc.observed, "expected": exc.expected}


# ---------------------------------------------------------------------------
# Worker-side reply dedup (idempotent resend support)
# ---------------------------------------------------------------------------


class DedupCache:
    """Bounded seq -> reply cache: the idempotent-resend half of the
    no-double-solve contract.

    The worker stores every reply here (keyed by the request's sequence
    id) BEFORE sending it; a resent request after a reconnect returns
    the cached reply instead of re-executing.  Capacity-bounded FIFO:
    the router's lockstep protocol keeps at most a handful of requests
    outstanding, so a small cache covers every legal resend while
    bounding memory on a long-lived worker.
    """

    def __init__(self, capacity: int = 64) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._cache: "OrderedDict[int, Any]" = OrderedDict()  # megba: guarded-by(_lock)
        self.hits = 0  # megba: guarded-by(_lock); resends served from cache

    def get(self, seq: int) -> Optional[Any]:
        with self._lock:
            reply = self._cache.get(int(seq))
            if reply is not None:
                self.hits += 1
            return reply

    def put(self, seq: int, reply: Any) -> None:
        with self._lock:
            self._cache[int(seq)] = reply
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)

    def hit_count(self) -> int:
        with self._lock:
            return self.hits


def heartbeat_frame(count: int, worker_id: str) -> Dict[str, Any]:
    return {HEARTBEAT_KEY: int(count), "worker_id": worker_id}


def is_heartbeat(frame: Any) -> bool:
    return isinstance(frame, dict) and HEARTBEAT_KEY in frame
