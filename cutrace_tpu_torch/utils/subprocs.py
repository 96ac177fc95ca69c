"""Subprocesses that start trees of processes (torchrun and its ranks),
run under a deadline and, past it, stopped whole.

A deadline terminates the process it started: torchrun passes SIGTERM on
to its ranks (each in a session of its own) and waits for them, then
kills those still running. A process that runs run_tree itself
(cutrace_tpu_torch.scaling under chip_smoke.py) calls
stop_on_sigterm() first, so that a deadline above it stops its own tree
too.
"""

from __future__ import annotations

import signal
import subprocess
import sys

# seconds a terminated tree has to end before it is killed: torchrun gives
# its ranks 30 s after SIGTERM, then kills them
STOP_S = 60


def stop_on_sigterm():
    """Turn SIGTERM into SystemExit, so that run_tree's clean-up stops the
    subprocess it is waiting on before this process ends."""
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))


def run_tree(cmd, cwd, env=None, timeout=None):
    """(exit code, stdout, stderr) of `cmd`; past `timeout` seconds it is
    terminated, killed if it has not ended STOP_S seconds later, and
    TimeoutError is raised with what it printed. An exception in the wait
    (SystemExit from stop_on_sigterm among them) stops it the same way."""
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        out, err = _stop(proc)
        raise TimeoutError(f"{' '.join(map(str, cmd[:6]))} ... ran past "
                           f"{timeout} s\n{out[-2000:]}\n{err[-4000:]}")
    except BaseException:
        _stop(proc)
        raise
    return proc.returncode, out, err


def _stop(proc):
    """Terminate `proc`, kill it past STOP_S; what it printed."""
    proc.terminate()
    try:
        return proc.communicate(timeout=STOP_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.communicate()


def failure_text(err: str, tail: int = 3000) -> str:
    """The lines of a failed torchrun's standard error that name an error
    (the ranks' own, which its summary leaves out), then its tail."""
    named = [ln for ln in err.splitlines()
             if "Error" in ln or "error:" in ln or "WARN" in ln]
    return "\n".join(named[-40:]) + "\n...\n" + err[-tail:]
