"""Failure detection + elastic restart for training runs — the port of
the JAX package's `utils/supervisor.py`, plain Python, unchanged in
behaviour.

The reference has no failure handling at all: runs are fire-and-forget
under ``nohup`` (survey section 5 — a failed nohup run is committed as
``test_log.txt``), and its ``load()`` is an unimplemented stub. This
port already has true checkpoint/resume (utils/checkpoint.py); the
supervisor closes the loop by DETECTING failures and restarting from the
last checkpoint:

- **crash detection**: nonzero child exit (Python exception, OOM kill,
  device fault, signal) triggers a restart with ``--resume`` appended.
- **hang detection**: a wedged device worker produces no output for
  hours while holding the card. If the
  child writes nothing to stdout/stderr for ``hang_timeout`` seconds it
  is killed — by its exact process group, never by pattern — and
  restarted.
- **restart budget**: at most ``max_restarts`` restarts, with a fixed
  backoff between attempts; a child that exits 0 ends supervision.

The supervised command is arbitrary (given after ``--``); by default
each RESTART appends ``--resume`` (once) so the training CLI continues
from its latest checkpoint. Pair with ``--save_checkpoints``.

Usage::

    python -m hypergraph_diffusion_for_recommendation_tpu_torch.utils.supervisor \
        --max_restarts 3 --hang_timeout 5400 -- \
        python -m hypergraph_diffusion_for_recommendation_tpu_torch.cli \
            --model=KHGRec --dataset=synthetic --save_checkpoints
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field


@dataclass
class SupervisorReport:
    """What happened across all attempts (one entry per child launch)."""

    outcomes: list[str] = field(default_factory=list)  # "ok" | "exit:<rc>" | "hang"
    final_returncode: int = -1

    @property
    def restarts(self) -> int:
        return max(0, len(self.outcomes) - 1)


def _pump(stream, sink, last_output_ts: list[float]) -> None:
    """Tee a child stream to ``sink`` while stamping activity time.

    Reads raw chunks (not lines) so ANY bytes — including \\r-only
    progress output — count as activity for the hang watchdog.
    """
    while True:
        chunk = stream.read1(65536)
        if not chunk:
            break
        last_output_ts[0] = time.monotonic()
        try:
            sink.buffer.write(chunk)
            sink.flush()
        except ValueError:  # sink closed during interpreter shutdown
            break
    stream.close()


def _kill_group(proc: subprocess.Popen, grace_s: float = 10.0) -> bool:
    """Terminate the child's exact process group (SIGTERM, then SIGKILL).

    Returns True once the child has been reaped. A SIGKILLed process
    stuck in uninterruptible device I/O can outlive the grace period;
    callers must not restart while it may still hold the device.
    """
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        proc.poll()  # reap if already exited
        return True
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(pgid, sig)
        except ProcessLookupError:
            pass
        try:
            proc.wait(timeout=grace_s)
            return True
        except subprocess.TimeoutExpired:
            continue
    # last chance: one longer reap window after SIGKILL
    try:
        proc.wait(timeout=60.0)
        return True
    except subprocess.TimeoutExpired:
        return False


def run_supervised(
    command: list[str],
    max_restarts: int = 3,
    hang_timeout: float | None = None,
    backoff_s: float = 5.0,
    resume_arg: str | None = "--resume",
    log=print,
) -> SupervisorReport:
    """Run ``command``; restart on crash or hang, up to ``max_restarts``.

    Restarted invocations get ``resume_arg`` appended once (set
    ``resume_arg=None`` to re-run verbatim). Returns a report with one
    outcome per attempt and the final return code (0 on success; the
    last failure's code, or 124 for a hang, when the budget runs out).
    """
    report = SupervisorReport()
    cmd = list(command)
    for attempt in range(max_restarts + 1):
        if attempt == 1 and resume_arg and resume_arg not in cmd:
            cmd = cmd + [resume_arg]
        log(f"[supervisor] attempt {attempt + 1}/{max_restarts + 1}: {' '.join(cmd)}")
        proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            start_new_session=True,  # own process group -> exact-PGID kill
            # without this a healthy child whose stdout is block-buffered
            # (pipes buffer ~8KB) would look silent to the hang watchdog
            env={**os.environ, "PYTHONUNBUFFERED": "1"},
        )
        last_output = [time.monotonic()]
        pump = threading.Thread(
            target=_pump, args=(proc.stdout, sys.stdout, last_output), daemon=True
        )
        pump.start()

        hung = False
        while True:
            try:
                proc.wait(timeout=1.0)
                break
            except subprocess.TimeoutExpired:
                pass
            if (
                hang_timeout is not None
                and time.monotonic() - last_output[0] > hang_timeout
            ):
                log(
                    f"[supervisor] no output for {hang_timeout:.0f}s — "
                    f"killing process group of pid {proc.pid}"
                )
                hung = True
                if not _kill_group(proc):
                    # unkillable (uninterruptible device I/O): restarting
                    # now would race the dying worker for the device and
                    # burn the budget — give up instead
                    log(
                        f"[supervisor] pid {proc.pid} survived SIGKILL "
                        "(uninterruptible I/O?) — not restarting"
                    )
                    report.outcomes.append("hang-unkillable")
                    report.final_returncode = 124
                    return report
                break
        pump.join(timeout=5.0)

        if hung:
            report.outcomes.append("hang")
            report.final_returncode = 124
        elif proc.returncode == 0:
            report.outcomes.append("ok")
            report.final_returncode = 0
            log(f"[supervisor] clean exit after {report.restarts} restart(s)")
            return report
        else:
            report.outcomes.append(f"exit:{proc.returncode}")
            report.final_returncode = proc.returncode
            log(f"[supervisor] child failed with code {proc.returncode}")

        if attempt < max_restarts:
            time.sleep(backoff_s)
    log(f"[supervisor] restart budget exhausted ({max_restarts} restarts)")
    return report


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--" not in argv:
        print("usage: supervisor [options] -- <command ...>", file=sys.stderr)
        return 2
    split = argv.index("--")
    opts, command = argv[:split], argv[split + 1 :]
    ap = argparse.ArgumentParser(prog="supervisor")
    ap.add_argument("--max_restarts", type=int, default=3)
    ap.add_argument(
        "--hang_timeout", type=float, default=None,
        help="seconds of child silence before it is killed and restarted",
    )
    ap.add_argument("--backoff", type=float, default=5.0)
    ap.add_argument(
        "--resume_arg", default="--resume",
        help="argument appended to restarted invocations ('' disables)",
    )
    args = ap.parse_args(opts)
    report = run_supervised(
        command,
        max_restarts=args.max_restarts,
        hang_timeout=args.hang_timeout,
        backoff_s=args.backoff,
        resume_arg=args.resume_arg or None,
    )
    return report.final_returncode


if __name__ == "__main__":
    sys.exit(main())
