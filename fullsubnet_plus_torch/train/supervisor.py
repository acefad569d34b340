"""Supervised recovery of a training run.

Counterpart of fullsubnet_plus_tpu/train/supervisor.py. The trainer
checkpoints and returns on the failures it can see (non-finite steps are
skipped, a SIGTERM or a device runtime error checkpoints for `-R`); this
makes the relaunch automatic. The supervisor watches the child trainer and
its `heartbeat.json` and relaunches it with `-R` (up to N times) when it
exits without finishing the run or its heartbeat stalls while it lives.
The reference's resume (audio_zen/trainer/base_trainer.py:128-157) needs a
person to relaunch.

Entry point: `python -m fullsubnet_plus_torch.cli.train -C cfg.toml
--supervise N [--heartbeat-timeout S]`. A finished run is the
`run_complete.json` marker the trainer writes after its last epoch: exit
codes cannot tell it from "checkpointed and exited for resume", since the
recovery paths return normally.

In a multi-rank run each rank's process has its own supervisor, all on the
same save directory: rank 0's writes `supervisor.json` and clears a stale
marker; the others write nothing and read rank 0's heartbeat and marker
(every rank steps together, and none exits before rank 0's files are
written, train/trainer.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _write_status(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)


def _heartbeat_age(save_dir: str):
    """Seconds since the trainer last proved liveness, or None if it never
    has (still starting)."""
    try:
        return time.time() - os.path.getmtime(
            os.path.join(save_dir, "heartbeat.json")
        )
    except OSError:
        return None


def supervise(train_argv, save_dir: str, max_restarts: int = 3,
              heartbeat_timeout: float = 1800.0, grace: float = 60.0,
              poll: float = 0.5, env=None, log=print,
              launcher=None, is_primary: bool = True) -> int:
    """Drive `cli.train <train_argv>` to completion; returns an exit code.

    * Child exits and `run_complete.json` exists -> success (0).
    * Child exits otherwise (crash, preemption checkpoint, dead-backend
      checkpoint-and-exit) -> relaunch with `-R`, up to `max_restarts`.
    * Heartbeat stalls for `heartbeat_timeout` s while the child is alive ->
      SIGTERM (the trainer checkpoints and exits at the next step boundary),
      escalate to SIGKILL of that exact pid after `grace` s, then relaunch.
      Before the first heartbeat the timer runs from the child's launch
      (kernel builds and the first steps count against it).

    Only the exact child pid is ever signaled, never a pattern.

    `supervisor.json` in `save_dir` records {pid, attempt, phase} for
    external monitoring (and the tests); a non-primary rank's supervisor
    (`is_primary` False) writes it not, nor clears the marker. `launcher` overrides the child
    command prefix (default: `python -m fullsubnet_plus_torch.cli.train`).
    """
    done_marker = os.path.join(save_dir, "run_complete.json")
    ckpt = os.path.join(save_dir, "checkpoints", "latest_model.npz")
    status_path = os.path.join(save_dir, "supervisor.json")
    if is_primary:
        os.makedirs(save_dir, exist_ok=True)
        if os.path.exists(done_marker):
            os.unlink(done_marker)  # stale marker from a previous completed run

    def write_status(payload: dict) -> None:
        if is_primary:
            _write_status(status_path, payload)

    attempt = 0
    while True:
        argv = list(train_argv)
        if ("-R" not in argv and "--resume" not in argv
                and os.path.exists(ckpt)):
            argv.append("-R")
        prefix = launcher or [sys.executable, "-m", "fullsubnet_plus_torch.cli.train"]
        cmd = list(prefix) + argv
        child = subprocess.Popen(cmd, env=env)
        log(f"[supervisor] attempt {attempt}: launched pid {child.pid}")
        write_status({
            "pid": child.pid, "attempt": attempt, "phase": "running",
            "cmd": cmd, "time": time.time(),
        })
        started = time.time()
        stalled = False
        while child.poll() is None:
            time.sleep(poll)
            age = _heartbeat_age(save_dir)
            since_launch = time.time() - started
            # A heartbeat older than this attempt's launch is the PREVIOUS
            # child's — measuring from it would kill every relaunch during
            # startup/compile. The liveness clock is the newer of (launch,
            # last heartbeat).
            waited = min(age, since_launch) if age is not None else since_launch
            if waited > heartbeat_timeout:
                stalled = True
                log(f"[supervisor] heartbeat stalled {waited:.0f}s > "
                    f"{heartbeat_timeout:.0f}s: SIGTERM pid {child.pid} "
                    f"(preemption checkpoint), SIGKILL after {grace:.0f}s")
                child.terminate()
                deadline = time.time() + grace
                while child.poll() is None and time.time() < deadline:
                    time.sleep(poll)
                if child.poll() is None:
                    child.kill()
                child.wait()
        rc = child.returncode

        if os.path.exists(done_marker):
            log(f"[supervisor] run complete after {attempt} restart(s)")
            write_status({
                "pid": child.pid, "attempt": attempt, "phase": "complete",
                "time": time.time(),
            })
            return 0
        reason = ("heartbeat stall" if stalled else
                  f"exit code {rc} without completion marker")
        if attempt >= max_restarts:
            log(f"[supervisor] giving up after {attempt} restart(s): {reason}")
            write_status({
                "pid": child.pid, "attempt": attempt, "phase": "failed",
                "reason": reason, "time": time.time(),
            })
            return rc if rc not in (0, None) else 1
        attempt += 1
        log(f"[supervisor] {reason}: relaunching with -R "
            f"({attempt}/{max_restarts})")
