"""Host-level kill-resume harness for preemption-safety checks.

Counterpart of `megba_tpu/robustness/harness.py`.  The checkpointed
drivers (algo/checkpointed.py) promise that a solve killed mid-chunk and
resumed is indistinguishable from an uninterrupted one.  This harness
delivers a real process death: it launches a worker subprocess, polls
for the first durable snapshot, SIGKILLs the worker (no atexit, no
signal handler, no flush: a preempted host), and reruns the worker to
completion against the surviving snapshot.  Its world form
(`run_world_until_snapshot_then_kill`) kills one rank of an N-process
world and requires every survivor to exit on its own (the elastic
no-wedge contract, robustness/elastic.py).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence


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


@dataclasses.dataclass
class WorldKillOutcome:
    """What `run_world_until_snapshot_then_kill` observed.

    `returncodes[kill_rank]` is the negative SIGKILL code; every other
    rank's code is whatever it exited with on its own (the elastic
    workers exit 0 after detection and the shrink-world resume).
    `outputs` maps rank -> combined stdout/stderr.  `kill_monotonic` is
    the harness clock at the SIGKILL, for latency cross-checks.
    """

    kill_rank: int
    returncodes: Dict[int, int]
    outputs: Dict[int, str]
    kill_monotonic: float


def run_world_until_snapshot_then_kill(
    worker_argvs: Sequence[Sequence[str]],
    snapshot_path: str,
    kill_rank: int = 1,
    rendezvous_argv: Optional[Sequence[str]] = None,
    timeout: float = 600.0,
    settle: float = 0.0,
    survivor_timeout: float = 600.0,
    env: Optional[dict] = None,
    worker_argvs_after_rendezvous=None,
) -> WorldKillOutcome:
    """Run an N-rank world; SIGKILL `kill_rank` at the first snapshot.

    `worker_argvs[i]` is rank i's argv.  `snapshot_path` is the durable
    snapshot to poll (conventionally rank 0's checkpoint: atomic by
    `save_state`'s temp + fsync + rename, so existence implies
    completeness).  The kill is a true SIGKILL mid-solve, after an
    optional `settle`.  Every surviving rank must then exit on its own
    within `survivor_timeout`: a survivor still running is killed and
    reported as a TimeoutError naming the wedge.  `rendezvous_argv`,
    when given, is launched first and SIGKILLed last (the sacrificial
    rendezvous process, `python -m megba_tpu_torch.parallel.multihost
    --serve <port> <world>`: it has no graceful teardown by design).
    With port 0 the rendezvous picks its port: pass
    `worker_argvs_after_rendezvous`, a callable from the rendezvous
    process's first output line to the workers' argvs, instead of
    `worker_argvs` (which may then be empty).

    Output goes to unbuffered temp files, never pipes, so a chatty
    worker cannot deadlock the poll loop.
    """
    n = len(worker_argvs)
    rdv = None
    rdv_log = tempfile.TemporaryFile()
    logs: List = []
    procs: List[subprocess.Popen] = []

    def drain(i: int) -> str:
        logs[i].seek(0)
        return logs[i].read().decode(errors="replace")

    def drain_all() -> str:
        return "\n".join(f"--- rank {i} ---\n{drain(i)}"
                         for i in range(len(logs)))

    try:
        deadline = time.monotonic() + timeout
        if rendezvous_argv is not None:
            rdv = subprocess.Popen(
                list(rendezvous_argv), env=env, stdout=rdv_log,
                stderr=subprocess.DEVNULL)
            if worker_argvs_after_rendezvous is not None:
                line = _first_line(rdv, rdv_log, deadline)
                worker_argvs = worker_argvs_after_rendezvous(line)
                n = len(worker_argvs)
        if not 0 <= kill_rank < n:
            raise ValueError(f"kill_rank {kill_rank} outside world {n}")
        # Appended one by one: if a later spawn raises, the ranks already
        # running are in `procs` and the finally block reaps them.
        for i, argv in enumerate(worker_argvs):
            logs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(
                list(argv), env=env, stdout=logs[i],
                stderr=subprocess.STDOUT))
        while True:
            if _snapshot_ready(snapshot_path):
                break
            for i, p in enumerate(procs):
                rc = p.poll()
                if rc is not None:
                    raise AssertionError(
                        f"rank {i} exited (rc={rc}) before the first "
                        f"snapshot at {snapshot_path!r}:\n{drain_all()}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no snapshot at {snapshot_path!r} within {timeout}s:"
                    f"\n{drain_all()}")
            time.sleep(0.005)
        if settle:
            time.sleep(settle)
        if procs[kill_rank].poll() is not None:
            raise AssertionError(
                f"rank {kill_rank} finished before the SIGKILL landed "
                f"(nothing was interrupted):\n{drain_all()}")
        kill_monotonic = time.monotonic()
        procs[kill_rank].kill()  # SIGKILL: uncatchable, nothing flushes
        procs[kill_rank].wait(timeout=60)

        # The no-wedge contract: survivors exit on their own, bounded.
        survivor_deadline = time.monotonic() + survivor_timeout
        for i, p in enumerate(procs):
            if i == kill_rank:
                continue
            remaining = survivor_deadline - time.monotonic()
            try:
                p.wait(timeout=max(remaining, 0.001))
            except subprocess.TimeoutExpired:
                raise TimeoutError(
                    f"survivor rank {i} still running "
                    f"{survivor_timeout}s after the kill — wedged past "
                    f"the watchdog budget:\n{drain_all()}")
        return WorldKillOutcome(
            kill_rank=kill_rank,
            returncodes={i: p.returncode for i, p in enumerate(procs)},
            outputs={i: drain(i) for i in range(n)},
            kill_monotonic=kill_monotonic,
        )
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        if rdv is not None and rdv.poll() is None:
            rdv.kill()
            rdv.wait(timeout=60)
        for log in logs + [rdv_log]:
            log.close()


def _first_line(proc: subprocess.Popen, log, deadline: float) -> str:
    """The first complete line `proc` wrote to `log` (a temp file)."""
    while True:
        log.seek(0)
        text = log.read().decode(errors="replace")
        if "\n" in text:
            return text.split("\n", 1)[0]
        if proc.poll() is not None:
            raise AssertionError(
                f"rendezvous exited (rc={proc.returncode}) before "
                f"printing its port: {text!r}")
        if time.monotonic() > deadline:
            raise TimeoutError("the rendezvous printed no line")
        time.sleep(0.005)


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

