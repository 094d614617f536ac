"""Stall-supervised training: the port's train CLI (run/train_torch.py)
under a watchdog that restarts it from its latest checkpoint when it stops
making progress.

What it guards against on the card: a call that never returns. A
collective of the NCCL process group that waits on a rank that died or
hung, or a device call stuck behind a hung kernel, leaves the process
alive with its log silent; a long run would sit there until someone
noticed. The watchdog turns that into a restart from the last checkpoint.

Mechanism, as the reference package's tools/train_supervisor.py, with the
same flags:
  - spawns `run/train_torch.py --cfg ... --save-every N [--resume]` in its
    own process group, its output appended to the log (--log);
  - watches the log: if no new bytes for --stall-timeout seconds once the
    steps flow (a "] loss" line was printed; before the first one,
    --compile-timeout: the kernels' nvcc build, the datasets and the first
    batch are silent), it sends SIGUSR1 (run/train_torch.py's faulthandler
    dumps every thread's stack into the log), waits --grace seconds, kills
    the process GROUP it created (never by name or pattern) and relaunches
    with --resume;
  - stops after more than --max-restarts consecutive attempts without
    progress (exit 1), or when the child exits 0.

    python -m fvp_torch.tools.train_supervisor \
        --cfg configs/shelf/jln64.yaml [--save-every 50] \
        [--stall-timeout 300] [--max-restarts 5] [-- extra args]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRAIN_SCRIPT = os.path.join(REPO, "run", "train_torch.py")
# seconds between two looks at the log, and before a relaunch after the
# child exited non-zero
POLL_S = 5.0
RELAUNCH_PAUSE_S = 10.0


def tail(path: str, n: int = 3) -> str:
    try:
        with open(path, "rb") as f:
            return b"\n".join(f.read().splitlines()[-n:]).decode(
                "utf-8", "replace")
    except OSError:
        return ""


def run_attempt(cmd: list[str], log_path: str, stall_timeout: float,
                grace: float,
                compile_timeout: float = 3600.0) -> tuple[int | None, bool]:
    """Run one training attempt. Returns (exit code, or None where it was
    killed for stalling; whether its log grew)."""
    with open(log_path, "ab") as log:
        log.write(f"\n=== supervisor: launching {' '.join(cmd)} ===\n"
                  .encode())
        log.flush()
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True, cwd=REPO)
    made_progress = False
    stepping = False
    last_size = os.path.getsize(log_path)
    last_change = time.monotonic()
    while True:
        rc = proc.poll()
        if rc is not None:
            return rc, made_progress
        time.sleep(POLL_S)
        size = os.path.getsize(log_path)
        limit = stall_timeout if stepping else compile_timeout
        if size != last_size:
            if not stepping:
                with open(log_path, "rb") as f:
                    f.seek(last_size)
                    if b"] loss" in f.read(size - last_size):
                        stepping = True
            last_size = size
            last_change = time.monotonic()
            made_progress = True
        elif time.monotonic() - last_change > limit:
            print(f"supervisor: no log progress for {limit:.0f}s "
                  f"— dumping stacks and restarting", flush=True)
            print(f"  last log lines:\n{tail(log_path)}", flush=True)
            try:
                os.kill(proc.pid, signal.SIGUSR1)   # faulthandler dump
                time.sleep(grace)
            except ProcessLookupError:
                pass
            try:
                # the process group created above, spawned children
                # included
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            return None, made_progress


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--save-every", type=int, default=50)
    parser.add_argument("--stall-timeout", type=float, default=300.0,
                        help="log-silence limit once training steps are "
                             "flowing")
    parser.add_argument("--compile-timeout", type=float, default=3600.0,
                        help="log-silence limit before the first step "
                             "line (the kernels' build, the datasets and "
                             "the first batch print nothing)")
    parser.add_argument("--grace", type=float, default=20.0)
    parser.add_argument("--max-restarts", type=int, default=5)
    parser.add_argument("--log", default=None)
    parser.add_argument("extra", nargs="*",
                        help="extra args forwarded to run/train_torch.py")
    args = parser.parse_args(argv)

    log_path = args.log or os.path.join(tempfile.gettempdir(),
                                        "supervised_train.log")
    base = [sys.executable, TRAIN_SCRIPT, "--cfg", args.cfg,
            "--save-every", str(args.save_every), *args.extra]

    no_progress = 0
    attempt = 0
    resume = False
    while True:
        attempt += 1
        cmd = base + (["--resume"] if resume else [])
        print(f"supervisor: attempt {attempt}", flush=True)
        rc, progressed = run_attempt(cmd, log_path, args.stall_timeout,
                                     args.grace, args.compile_timeout)
        if rc == 0:
            print("supervisor: training completed", flush=True)
            return 0
        resume = True                  # anything after attempt 1 resumes
        if progressed:
            no_progress = 0
        else:
            no_progress += 1
            if no_progress > args.max_restarts:
                print(f"supervisor: {no_progress} consecutive attempts "
                      f"with zero progress — giving up", flush=True)
                return 1
        if rc is not None:
            print(f"supervisor: child exited rc={rc}; restarting with "
                  f"--resume", flush=True)
            time.sleep(RELAUNCH_PAUSE_S)


if __name__ == "__main__":
    raise SystemExit(main())
