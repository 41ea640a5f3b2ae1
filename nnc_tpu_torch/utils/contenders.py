"""Pausing the host's other CPU-bound jobs while a benchmark runs.

Counterpart of the root ``bench.py``'s ``PAUSE_FILE``,
``_pause_contenders`` and ``_resume_contenders``, kept in a host-only
module of their own: a background CPU-bound job (a long RD sweep, say)
slows the codec's MB/s and inflates every timing loop, so long-running
helpers register their pid in :data:`PAUSE_FILE` and the bench stops them
for its run (:func:`paused`). The file lies in the temporary directory
(``tempfile.gettempdir()``, which ``TMPDIR`` moves).
"""
from __future__ import annotations

import contextlib
import os
import signal
import tempfile

# the pids of processes to pause while the bench runs, one per line
PAUSE_FILE = os.path.join(tempfile.gettempdir(), "nnc_bench_pause.pids")


def _pause_contenders(stopped=None):
    """SIGSTOP the pids registered (one per line) in :data:`PAUSE_FILE`.
    Registered pids are expanded to their live descendants (SIGSTOP does
    not propagate: stopping a ``bash wrapper.sh`` leaves its python child
    running), parents before their children so that nothing new is spawned
    mid-pause. Ancestors of this process are never paused (a stopped parent
    shell would never reap it). Stopped pids are appended to ``stopped`` in
    place (so that a SIGTERM arriving mid-pause still leaves them to the
    caller's resume), which is also returned."""
    if stopped is None:
        stopped = []
    try:
        with open(PAUSE_FILE) as f:
            pids = [int(tok) for tok in f.read().split()]
    except (OSError, ValueError):
        return stopped
    ancestors = set()
    p = os.getpid()
    while p > 1:
        try:
            with open(f"/proc/{p}/status") as f:
                p = int(next(ln for ln in f
                             if ln.startswith("PPid:")).split()[1])
        except (OSError, StopIteration, ValueError, IndexError):
            break
        ancestors.add(p)
    # self and ancestors are dropped BEFORE the descendants' expansion:
    # expanding an ancestor would sweep in this process's siblings
    roots = [pid for pid in pids
             if pid != os.getpid() and pid not in ancestors]
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                # field 4 is ppid; field 2 (comm) may hold spaces but is
                # parenthesised: split after the closing paren
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    seen = set()
    frontier = list(roots)
    expanded = []
    while frontier:
        pid = frontier.pop(0)
        if pid in seen:
            continue
        seen.add(pid)
        expanded.append(pid)
        frontier.extend(children.get(pid, []))
    for pid in expanded:
        try:
            os.kill(pid, signal.SIGSTOP)
            stopped.append(pid)
        except OSError:
            pass
    return stopped


def _resume_contenders(pids):
    """SIGCONT each of ``pids`` that still lives."""
    for pid in pids:
        try:
            os.kill(pid, signal.SIGCONT)
        except OSError:
            pass


@contextlib.contextmanager
def paused():
    """The registered processes stopped for the block, resumed after it
    however it ends (a SIGTERM too, once turned into SystemExit)."""
    stopped = []
    try:
        _pause_contenders(stopped)
        yield stopped
    finally:
        _resume_contenders(stopped)
