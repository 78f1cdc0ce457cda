"""One process per card for a cell that asks for several chips.

The process the benchmark is started as is rank 0 on ``cuda:0``. Before its
own imports it starts ranks 1..n-1 (:func:`spawn`): the same script with
the same arguments plus ``--rank``, ``--world`` and ``--store``. Every rank
makes its own pool from the seed and runs the same window; the program's
fit joins them over its own NCCL group. All the control between the ranks
runs on the host, through a ``torch.distributed.FileStore`` in the store
directory (:class:`Link`): the pools' checksums, set-up done, go or stop
before each fit, one barrier after each fit, and each rank's results after
the window. No control message does any work on a card.

A rank that raises or exits ends the run: rank 0 watches its children from
a thread (:meth:`Children.watch`) and exits hard if one dies, and each child
exits when rank 0 is gone (:func:`follow_parent`).

Nothing here runs at import time, and nothing here imports torch before a
function needs it.
"""

import ctypes
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

# prctl option: the signal a process gets when its parent exits
_PR_SET_PDEATHSIG = 1
# seconds any rank waits for a control message before the run fails
STORE_TIMEOUT_S = 300
# seconds rank 0 waits for its children to exit once they have posted
EXIT_WAIT_S = 30


def cpus_of(rank: int, world: int, log: Callable[[str], None]) -> List[int]:
    """Two CPUs of this rank's own when the machine has two per rank (rank 0
    the last two, rank 1 the two before them, ...); else every CPU, shared,
    said on ``log``."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 2 * world:
        hi = len(cpus) - 2 * rank
        return cpus[hi - 2 : hi]
    log(f"{len(cpus)} CPUs for {world} ranks: the ranks share CPUs")
    return cpus


def follow_parent() -> None:
    """End this process when its parent (rank 0) is gone: the kernel's
    parent-death signal, and a thread that polls ``getppid`` besides."""
    parent = os.getppid()
    try:
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    except (OSError, AttributeError):
        pass  # the polling thread still ends the process

    def poll() -> None:
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    if os.getppid() != parent:
        os._exit(1)
    threading.Thread(target=poll, name="follow-parent", daemon=True).start()


class Children:
    """Ranks 1..n-1 as child processes of rank 0, their standard error
    copied line by line to rank 0's with the rank in front."""

    def __init__(self, procs: List[subprocess.Popen]):
        self.procs = procs
        self.finishing = False
        self._copiers = [
            threading.Thread(target=self._copy, args=(r, p), name=f"rank{r}-stderr", daemon=True)
            for r, p in enumerate(procs, start=1)
        ]
        for t in self._copiers:
            t.start()

    @staticmethod
    def _copy(rank: int, proc: subprocess.Popen) -> None:
        for line in proc.stderr:
            sys.stderr.write(f"[rank {rank}] {line}")
            sys.stderr.flush()

    def watch(self, log: Callable[[str], None]) -> None:
        """From a thread: once a child exits with a code other than 0 (a
        child exits 0 only after it has posted its results), stop the
        others and end this process with code 1."""

        def poll() -> None:
            while not self.finishing:
                for r, p in enumerate(self.procs, start=1):
                    code = p.poll()
                    if code is not None and code != 0:
                        self.kill()
                        self._drain()
                        log(f"rank {r} exited with code {code}: ending the run")
                        os._exit(1)
                time.sleep(0.2)

        threading.Thread(target=poll, name="watch-ranks", daemon=True).start()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def finish(self, log: Callable[[str], None]) -> bool:
        """Wait for every child to exit (at most ``EXIT_WAIT_S`` seconds,
        then kill what is left); True when each exited with code 0."""
        self.finishing = True
        deadline = time.monotonic() + EXIT_WAIT_S
        clean = True
        for r, p in enumerate(self.procs, start=1):
            try:
                code = p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                log(f"rank {r} still running {EXIT_WAIT_S} s after its results: killed")
                p.kill()
                code = p.wait()
            if code != 0:
                log(f"rank {r} exited with code {code}")
            clean = clean and code == 0
        self._drain()
        return clean

    def _drain(self) -> None:
        """Wait (briefly) until the exited children's last lines of
        standard error have been copied."""
        for t in self._copiers:
            t.join(timeout=5.0)


def spawn(script: str, argv: List[str], world: int, store_dir: str) -> Children:
    """Start ranks 1..world-1: ``script`` with ``argv`` and the rank's
    arguments. Their standard output goes to rank 0's standard error, so
    that only rank 0 prints to standard output."""
    procs = [
        subprocess.Popen(
            [sys.executable, script, *argv, "--rank", str(r), "--world", str(world), "--store", store_dir],
            stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno(), stderr=subprocess.PIPE, text=True,
        )
        for r in range(1, world)
    ]
    return Children(procs)


class Link:
    """This rank's end of the host-side control messages of one run.

    ``init_url`` is the ``torch.distributed`` init URL the program's own
    process group joins by (a file beside the control store)."""

    def __init__(self, rank: int, world: int, store_dir: str):
        from datetime import timedelta

        import torch.distributed as dist

        self.rank, self.world = rank, world
        self.init_url = "file://" + str(Path(store_dir) / "program_group")
        self.store = dist.FileStore(str(Path(store_dir) / "control"), -1)
        self.store.set_timeout(timedelta(seconds=STORE_TIMEOUT_S))

    def _keys(self, tag: str) -> List[str]:
        return [f"{tag}/{r}" for r in range(self.world)]

    def agree(self, tag: str, value: str) -> None:
        """Every rank's ``value`` must equal rank 0's; raises RuntimeError
        on each rank otherwise."""
        self.store.set(f"{tag}/{self.rank}", value)
        if self.rank == 0:
            self.store.wait(self._keys(tag))
            values = [self.store.get(k).decode() for k in self._keys(tag)]
            bad = [r for r, v in enumerate(values) if v != value]
            verdict = "ok" if not bad else f"ranks {bad} differ from rank 0: {values}"
            self.store.set(f"{tag}/verdict", verdict)
        else:
            verdict = self.store.get(f"{tag}/verdict").decode()
        if verdict != "ok":
            raise RuntimeError(f"{tag}: {verdict}")

    def barrier(self, tag: str) -> None:
        """Returns once every rank has reached ``tag``."""
        self.store.set(f"{tag}/{self.rank}", "1")
        self.store.wait(self._keys(tag))

    def go(self, i: int, go: bool) -> bool:
        """Whether fit ``i`` runs: rank 0's ``go``, sent to the others."""
        if self.rank == 0:
            self.store.set(f"go/{i}", "1" if go else "0")
            return go
        return self.store.get(f"go/{i}").decode() == "1"

    def fit_done(self, i: int) -> None:
        """Says that this rank's fit ``i`` has returned, its card
        synchronized; on rank 0, waits until every rank has said so."""
        self.store.set(f"done/{i}/{self.rank}", "1")
        if self.rank == 0:
            self.store.wait([f"done/{i}/{r}" for r in range(self.world)])

    def post(self, result: Dict) -> None:
        self.store.set(f"result/{self.rank}", json.dumps(result))

    def collect(self) -> Dict[int, Dict]:
        """On rank 0: every other rank's posted result."""
        return {r: json.loads(self.store.get(f"result/{r}")) for r in range(1, self.world)}


def exit_now(code: int, store_dir: Optional[str] = None) -> None:
    """Flush, remove the store directory and end the process at once,
    without running the process group's destructors (which may wait on
    ranks that are gone)."""
    import shutil

    sys.stdout.flush()
    sys.stderr.flush()
    if store_dir:
        shutil.rmtree(store_dir, ignore_errors=True)
    os._exit(code)
