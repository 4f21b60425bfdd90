"""Producer processes: the bank's asynchronous refresh and the warm reset.

Counterpart of ``tetris_piclim_tpu/gen/_producers.py``: top-level producer
functions (picklable under spawn) after the reference's two warm-reset
workers (game/tetris.py:473-488), and :class:`ProducerPool`, which runs
them for ``ConfigBank.start_refresh`` and ``env_api.Tetris``. The
generators are GIL-bound Python and numpy, so they run in processes of
their own. This module and what it imports load numpy and the standard
library only: no torch, no CUDA.

Each producer sends its items down a pipe of its own, whose write end only
the producer holds, and watches a :class:`StopFlag`. The JAX package shares
one ``multiprocessing.Queue`` and one ``multiprocessing.Event`` among its
producers; a producer killed while it holds the queue's write lock or the
event's lock blocks every later put or check, and one killed inside a put
leaves half a message that blocks the reader. Here no lock is shared
between processes: a dead producer's pipe reads as end-of-file, and the
pool closes it and never reads it again.
"""

from __future__ import annotations

import multiprocessing
import random
import select
import time
from multiprocessing import connection

FAMILY_CARVE = 0
FAMILY_FORWARD = 1
MAX_RESTARTS = 5  # producer restarts per pool, as in JAX


class StopFlag:
    """A stop signal shared with producer processes: one byte of shared
    memory, written and read without a lock, so a producer killed at any
    point leaves it usable."""

    def __init__(self, ctx) -> None:
        self._flag = ctx.RawValue("b", 0)

    def set(self) -> None:
        self._flag.value = 1

    def is_set(self) -> bool:
        return bool(self._flag.value)


def _put(conn, stop, item) -> bool:
    """Send ``item`` once the pipe has room, checking ``stop`` every 0.2 s
    meanwhile. False when ``stop`` is set or the reader has closed its end
    (the producer then returns)."""
    try:
        while not stop.is_set():
            if select.select([], [conn], [], 0.2)[1]:
                conn.send(item)
                return True
    except (BrokenPipeError, ConnectionResetError):
        pass
    return False


def carve_producer(conn, stop, L, M, seed, batch) -> None:
    """Carving producer (reference warm_reset_worker, game/tetris.py:473-479):
    batches of ``batch`` carves from ``random.Random(seed)``."""
    from .carver import CarvingGenerator

    rng = random.Random(seed)
    while not stop.is_set():
        items = []
        for _ in range(batch):
            if stop.is_set():
                return
            items.append(CarvingGenerator(L, M, rng=rng).generate())
        if not _put(conn, stop, (FAMILY_CARVE, items)):
            return


def forward_producer(conn, stop, L, M, parity, seed_start, window, seed) -> None:
    """Forward generate-and-prove producer (reference
    forward_warm_reset_worker, game/tetris.py:482-488) over rotating seed
    windows of ``window`` seeds from ``seed_start`` (the reference pins
    seeds 0..99 and makes the same 100 boards forever)."""
    from .pipeline import generate_batch, translate_batch

    rng = random.Random(seed)
    s = seed_start
    while not stop.is_set():
        games = generate_batch(L, M, seed_start=s, seed_end=s + window)
        s += window
        items = translate_batch(games, M, rng=rng, parity=parity)
        if items and not stop.is_set() and not _put(conn, stop,
                                                     (FAMILY_FORWARD, items)):
            return


class ProducerPool:
    """Producer processes started from ``specs`` (``[(fn, args), ...]``,
    each called as ``fn(conn, stop, *args)``) in the spawn context, each
    with a pipe of its own. ``slots[i] = [process, reader]``; the reader is
    None once its pipe is closed."""

    def __init__(self, specs) -> None:
        self._ctx = multiprocessing.get_context("spawn")
        self.stop_flag = StopFlag(self._ctx)
        self.specs = list(specs)
        self.restarts = 0
        self.slots = [self._spawn(fn, args) for fn, args in self.specs]

    def _spawn(self, fn, args) -> list:
        reader, writer = self._ctx.Pipe(duplex=False)
        proc = self._ctx.Process(target=fn, args=(writer, self.stop_flag, *args),
                                 daemon=True)
        proc.start()
        writer.close()  # the producer holds the only write end
        return [proc, reader]

    def receive(self, timeout: float):
        """Yield the items waiting in the pipes of live producers, after
        waiting up to ``timeout`` for the first. A pipe that ends (its
        producer died, perhaps inside a send) is closed."""
        live = {slot[1]: slot for slot in self.slots
                if slot[1] is not None and slot[0].is_alive()}
        for reader in connection.wait(list(live), timeout=timeout):
            try:
                item = reader.recv()
            except (EOFError, OSError):
                reader.close()
                live[reader][1] = None
                continue
            yield item

    def restart_dead(self) -> None:
        """Restart each producer that died, with a fresh pipe, while the
        pool is not stopping, at most MAX_RESTARTS in all; the dead one's
        pipe is closed unread."""
        for i, (proc, reader) in enumerate(self.slots):
            if (not proc.is_alive() and not self.stop_flag.is_set()
                    and self.restarts < MAX_RESTARTS):
                if reader is not None:
                    reader.close()
                proc.join(timeout=1)  # reap
                self.slots[i] = self._spawn(*self.specs[i])
                self.restarts += 1

    def any_alive(self) -> bool:
        return any(proc.is_alive() for proc, _ in self.slots)

    def close(self, grace_s: float = 1.0) -> None:
        """Signal every producer, drain the pipes for up to ``grace_s``
        seconds so a producer blocked in a send can see the signal and
        return, join them, and terminate any still running (one inside a
        forward seed window). No process outlives this call."""
        self.stop_flag.set()
        deadline = time.monotonic() + grace_s
        while self.any_alive() and time.monotonic() < deadline:
            if not any(True for _ in self.receive(0.1)):
                time.sleep(0.05)
        for proc, reader in self.slots:
            proc.join(timeout=0.5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
            if reader is not None:
                reader.close()
        self.slots = []
