"""Host-level kill-resume harness for preemption-safety checks.

Counterpart of `megba_tpu/robustness/harness.py` (its one-process half).
The checkpointed drivers (algo/checkpointed.py) promise that a solve
killed mid-chunk and resumed is indistinguishable from an uninterrupted
one.  This harness delivers a real process death: it launches a worker
subprocess, polls for the first durable snapshot, SIGKILLs the worker
(no atexit, no signal handler, no flush: a preempted host), and reruns
the worker to completion against the surviving snapshot.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence


def _snapshot_ready(path: str) -> bool:
    """A snapshot counts once it exists with nonzero size.  save_state
    writes tmp + fsync + os.replace, so existence implies completeness."""
    try:
        return os.path.getsize(path) > 0
    except OSError:
        return False


def run_until_snapshot_then_kill(
    argv: Sequence[str],
    checkpoint_path: str,
    timeout: float = 300.0,
    settle: float = 0.0,
    env: Optional[dict] = None,
) -> int:
    """Run `argv`, SIGKILL it as soon as `checkpoint_path` appears.

    Returns the (negative-signal) returncode.  `settle` optionally lets
    the worker run a little past the first snapshot so the kill lands
    mid-chunk rather than at the exact chunk boundary.  Raises
    TimeoutError if no snapshot (or exit) happens within `timeout`, and
    AssertionError if the worker exits before its first snapshot or
    finishes before the SIGKILL lands.

    Worker output goes to an unbuffered temp file, not a pipe: the
    harness never drains while polling, and a worker chatty enough to
    fill a pipe buffer before its first snapshot would deadlock against
    it (the output is read back only on the error paths).
    """
    with tempfile.TemporaryFile() as log:
        proc = subprocess.Popen(
            list(argv), env=env, stdout=log, stderr=subprocess.STDOUT)

        def drain():
            log.seek(0)
            return log.read().decode(errors="replace")

        deadline = time.monotonic() + timeout
        try:
            while True:
                if _snapshot_ready(checkpoint_path):
                    if settle:
                        time.sleep(settle)
                    proc.kill()  # SIGKILL: uncatchable, nothing flushes
                    proc.wait(timeout=60)
                    if proc.returncode == 0:
                        raise AssertionError(
                            "worker finished before the SIGKILL landed "
                            "(the run completed cleanly — nothing was "
                            f"interrupted):\n{drain()}")
                    return proc.returncode
                rc = proc.poll()
                if rc is not None:
                    raise AssertionError(
                        f"worker exited (rc={rc}) before writing a "
                        f"snapshot at {checkpoint_path!r}:\n{drain()}")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no snapshot at {checkpoint_path!r} within "
                        f"{timeout}s; worker output:\n{drain()}")
                time.sleep(0.002)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)


def run_to_completion(argv: Sequence[str], timeout: float = 600.0,
                      env: Optional[dict] = None) -> str:
    """Run `argv` to completion; returns combined stdout/stderr.  Raises
    with the captured output on a nonzero exit."""
    res = subprocess.run(
        list(argv), env=env, timeout=timeout,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = res.stdout.decode(errors="replace")
    if res.returncode != 0:
        raise AssertionError(
            f"worker failed (rc={res.returncode}):\n{out}")
    return out


def python_worker(script_path: str, *args: str) -> List[str]:
    """argv for running a worker script under this interpreter."""
    return [sys.executable, script_path, *map(str, args)]
