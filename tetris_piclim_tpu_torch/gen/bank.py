"""Bank of winnable start configurations on the device, its refresh, and
the held-out evaluation bank.

Counterpart of ``tetris_piclim_tpu/gen/bank.py``: the bank keeps B winnable
(board, piece-sequence) rows in device memory, and the env auto-reset draws
rows from it with no host involvement. Rows come from two families, carves
and forward games proven winnable, and are made in one of two ways:

* on the host (:meth:`ConfigBank.fill`, the trainer's default bank): the
  seed-exact host carver (:mod:`.carver`) and the host forward pipeline
  (:mod:`.pipeline`), row for row the JAX bank's at the same seed; and
  background producer processes (:meth:`ConfigBank.start_refresh`) that
  swap fresh host rows into the live bank while training runs;
* on the device (:meth:`ConfigBank.fill_device` / ``refresh_device``): the
  lockstep carver (:mod:`.device_carver`) and, for a ``forward_fraction``
  share, forward games proven by the beam prover (:mod:`.device_forward`).

:func:`make_holdout_bank` builds an evaluation bank that is checked to be
disjoint from a training bank.

Boards are kept packed (int32[B, 10] column words, the layout the step and
the kernels read); the JAX bank keeps bool[B, 20, 10] and packs per chunk.
The device rows are one pair, ``rows = (cols, pieces)``, rebound whole under
the bank's lock, so a reader that takes the pair once never sees boards of
one generation with pieces of another. The per-row ``family`` stays on the
host.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..ops.bitboard import pack_board, unpack_board
from ..utils.device import resolve_device
from . import device_carver, device_forward
from ._producers import FAMILY_CARVE, FAMILY_FORWARD
from .carver import CarvingGenerator
from .pipeline import generate_batch, translate_batch

# Prove-chunk cap: the forward generator runs in chunks of at most this many
# candidates, whatever the bank's size; small banks use the next power of two
# that covers their own need (see _fwd_chunk_for).
_FWD_CHUNK = 1024


def _fwd_chunk_for(n_needed: int) -> int:
    """The smallest power of two covering ``n_needed``, capped at
    _FWD_CHUNK."""
    n = 1
    while n < n_needed and n < _FWD_CHUNK:
        n <<= 1
    return n


def _row_key(board: np.ndarray, pieces: np.ndarray) -> bytes:
    """A row's identity: bool[20, 10] board bits + int8 piece bytes (the
    JAX bank's key, so identities compare across the two packages)."""
    return np.packbits(board).tobytes() + pieces.tobytes()


def pack_host_rows(items: list, P: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Host (board, pieces) rows as the bank stores them, on the CPU:
    int32[n, 10] packed boards and int8[n, P] pieces, each piece list cut or
    zero-padded to P."""
    boards = torch.as_tensor(np.stack([np.asarray(b, dtype=bool) for b, _ in items]))
    pieces = np.asarray([(list(p) + [0] * P)[:P] for _, p in items], dtype=np.int8)
    return pack_board(boards), torch.as_tensor(pieces)


class ConfigBank:
    """Fixed-capacity bank: ``rows = (cols, pieces)``, int32[B, 10] and
    int8[B, M+1] on ``device``, and ``family`` int8[B] (FAMILY_CARVE /
    FAMILY_FORWARD) on the host.

    ``parity_translate`` makes the host forward rows keep the reference's
    prepended random first piece (``translate_batch(parity=True)``);
    ``forward_share_cap`` bounds the forward share that the asynchronous
    refresh grows the bank to."""

    def __init__(self, L: int, M: int, capacity: int = 1024, seed: int = 0,
                 device="cuda", parity_translate: bool = False,
                 forward_share_cap: float = 0.25):
        self.L, self.M = L, M
        self.capacity = capacity
        self.P = M + 1
        self.device = resolve_device(device)
        self.parity_translate = parity_translate
        self.forward_share_cap = forward_share_cap
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # host draws, as the JAX bank's: carves, forward pieces and producer
        # seeds from _rng, refresh target rows from _np_rng
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        # reentrant: refresh_device holds it across fill_device
        self._lock = threading.RLock()
        self.rows: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        self.family = np.zeros(capacity, dtype=np.int8)
        self._refresh_writes = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._pool = None  # the producers of start_refresh

    @property
    def cols(self) -> Optional[torch.Tensor]:
        return None if self.rows is None else self.rows[0]

    @property
    def pieces(self) -> Optional[torch.Tensor]:
        return None if self.rows is None else self.rows[1]

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        if seed is None:
            return self._gen
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- host rows --------------------------------------------------------------

    def _carve_one(self) -> tuple[np.ndarray, list[int]]:
        return CarvingGenerator(self.L, self.M, rng=self._rng).generate()

    def fill(self, carve_fraction: float = 1.0, seed_start: int = 0,
             forward_seed_budget: int = 10_000) -> "ConfigBank":
        """Fill every row on the host, as the JAX bank's ``fill``: the first
        ``capacity * carve_fraction`` rows carved, the rest forward games
        proven by the DFS solver from seed windows of 100 starting at
        ``seed_start``; when ``forward_seed_budget`` seeds fall short (the
        solver's yield collapses on hard tasks), carves fill the rest. The
        rows are packed and uploaded to the bank's device."""
        items, family = [], []
        n_carve = int(self.capacity * carve_fraction)
        for _ in range(n_carve):
            items.append(self._carve_one())
            family.append(FAMILY_CARVE)
        seed = seed_start
        while len(items) < self.capacity and seed < seed_start + forward_seed_budget:
            games = generate_batch(self.L, self.M, seed_start=seed, seed_end=seed + 100)
            seed += 100
            # every game is translated (one draw each), as in JAX, before
            # the rows past capacity are dropped
            for row in translate_batch(games, self.M, rng=self._rng,
                                       parity=self.parity_translate):
                if len(items) < self.capacity:
                    items.append(row)
                    family.append(FAMILY_FORWARD)
        while len(items) < self.capacity:  # forward shortfall -> carves
            items.append(self._carve_one())
            family.append(FAMILY_CARVE)
        cols, pieces = pack_host_rows(items, self.P)
        with self._lock:
            self.rows = (cols.to(self.device), pieces.to(self.device))
            self.family[:] = family
        return self

    def allocate(self) -> "ConfigBank":
        """Rows of zeros of the bank's shape on its device: the bank of a
        rank of a data-parallel mesh, which rank 0's rows overwrite
        (``parallel/mesh.py::shard_bank``) without a fill of its own."""
        with self._lock:
            self.rows = (torch.zeros((self.capacity, 10), dtype=torch.int32,
                                     device=self.device),
                         torch.zeros((self.capacity, self.P), dtype=torch.int8,
                                     device=self.device))
        return self

    @property
    def refresh_writes(self) -> int:
        """Rows written by the asynchronous refresh since the bank was made."""
        return self._refresh_writes

    # -- device rows ------------------------------------------------------------

    def _device_rows(self, gen: torch.Generator, forward_fraction: float,
                     initial_height_max: int, oversample: int,
                     beam_width: int):
        """A whole bank of device rows: carves, with up to
        ``capacity * forward_fraction`` proven forward rows in rows
        [0:n_got]. The forward generator runs in fixed chunks, oversampling
        ``oversample`` x and keeping winners; it stops once it is within 2%
        of its share, and any shortfall stays carve-family. Returns
        (cols, pieces, n_got)."""
        batch = device_carver.generate_batch_device(
            self.capacity, self.L, self.M, generator=gen, device=self.device)
        cols, pieces = batch.boards, batch.pieces
        n_fwd = int(self.capacity * forward_fraction)
        if n_fwd == 0:
            return cols, pieces, 0
        chunk = _fwd_chunk_for(oversample * n_fwd)
        slack = int(0.02 * n_fwd)
        wins, boards, seqs = [], [], []
        have = 0
        for _ in range(-(-oversample * n_fwd // chunk)):
            if have >= n_fwd - slack:
                break
            fb = device_forward.generate_batch_device(
                chunk, self.L, self.M, initial_height_max, beam_width,
                generator=gen, device=self.device)
            wins.append(fb.winnable)
            boards.append(fb.boards)
            seqs.append(fb.pieces)
            have += int(fb.winnable.sum())  # one scalar sync per chunk
        n_got = min(have, n_fwd)
        take = torch.cat(wins).nonzero()[:n_got, 0]  # winners, in order
        cols[:n_got] = torch.cat(boards)[take]
        pieces[:n_got] = torch.cat(seqs)[take]
        return cols, pieces, n_got

    def fill_device(self, seed: Optional[int] = None,
                    forward_fraction: float = 0.0,
                    initial_height_max: int = 4, oversample: int = 3,
                    beam_width: int = 8) -> "ConfigBank":
        """Fill every row on the device: carves, and a ``forward_fraction``
        share of proven forward-family rows (rows [0:n] of the bank).
        ``seed`` starts a fresh stream, None continues the bank's own.
        The bank's lock is held across the generation, so host rows that a
        producer sends meanwhile land after it, in the new rows."""
        with self._lock:
            cols, pieces, n_got = self._device_rows(
                self._generator(seed), forward_fraction, initial_height_max,
                oversample, beam_width)
            self.rows = (cols, pieces)
            self.family[:] = FAMILY_CARVE
            self.family[:n_got] = FAMILY_FORWARD
        return self

    def refresh_device(self, seed: Optional[int] = None,
                       forward_fraction: float = 0.0,
                       initial_height_max: int = 4, oversample: int = 3,
                       beam_width: int = 8) -> "ConfigBank":
        """Regenerate rows on the device with fresh configurations.

        ``forward_fraction == 0``: the carve-family rows are regenerated and
        the forward-family rows (those of the host producers too) kept.
        ``forward_fraction > 0``: the whole bank is regenerated as a carve +
        proven-forward mix, as by :meth:`fill_device`. As in JAX, the bank's
        lock is held across the generation: a producer's
        :meth:`_swap_rows` waits and lands in the new rows."""
        with self._lock:
            if forward_fraction > 0 or self.rows is None:
                return self.fill_device(seed, forward_fraction, initial_height_max,
                                        oversample, beam_width)
            batch = device_carver.generate_batch_device(
                self.capacity, self.L, self.M, generator=self._generator(seed),
                device=self.device)
            carve = torch.as_tensor(self.family == FAMILY_CARVE,
                                    device=self.device)[:, None]
            cols, pieces = self.rows
            self.rows = (torch.where(carve, batch.boards, cols),
                         torch.where(carve, batch.pieces, pieces))
        return self

    # -- asynchronous refresh ---------------------------------------------------

    def _swap_rows(self, fresh: list, family: int) -> None:
        """Write fresh host rows of ``family`` into target rows drawn from
        the bank's numpy generator, as the JAX bank's ``_swap_rows``: carve
        rows replace carve rows only (the carver is orders of magnitude
        faster than the prover and would wash the forward rows out); forward
        rows replace carve rows until the forward share reaches
        ``forward_share_cap``, then recycle forward rows. A row drawn twice
        keeps its last write. The new pair is built from the old on the
        device (the caller's thread, default stream, synchronous upload) and
        rebound whole."""
        with self._lock:
            if family == FAMILY_FORWARD:
                cap_rows = int(self.capacity * self.forward_share_cap)
                n_fwd = int((self.family == FAMILY_FORWARD).sum())
                pool_family = FAMILY_FORWARD if n_fwd >= cap_rows else FAMILY_CARVE
            else:
                pool_family = FAMILY_CARVE
            pool = np.flatnonzero(self.family == pool_family)
            if len(pool) == 0:
                pool = np.arange(self.capacity)
            targets = self._np_rng.choice(pool, size=len(fresh),
                                          replace=len(pool) < len(fresh))
            last = {int(row): k for k, row in enumerate(targets)}
            cols_new, pieces_new = pack_host_rows([fresh[k] for k in last.values()],
                                              self.P)
            idx = torch.as_tensor(list(last), device=self.device)
            cols, pieces = self.rows
            self.rows = (cols.index_put((idx,), cols_new.to(self.device)),
                         pieces.index_put((idx,), pieces_new.to(self.device)))
            self.family[list(last)] = family
            self._refresh_writes += len(fresh)

    def _consume(self) -> None:
        """Consumer thread: swap each batch a producer sends into the bank,
        and restart a producer that died."""
        while not self._stop.is_set():
            for fam, items in self._pool.receive(0.2):
                self._swap_rows(items, fam)
            self._pool.restart_dead()

    def start_refresh(self, n_threads: int = 1, batch_per_cycle: int = 32,
                      forward: bool = True, forward_seed_start: int = 0,
                      forward_window: int = 100) -> None:
        """Start background producer processes that keep swapping fresh host
        rows into the bank (the reference's two-producer design,
        game/tetris.py:473-488): ``n_threads`` carving producers, each
        sending batches of ``batch_per_cycle`` carves, and (``forward``) one
        forward producer over rotating windows of ``forward_window`` seeds
        from ``forward_seed_start``. Producer seeds come from the bank's
        ``random.Random`` in the JAX bank's order.

        Processes, not threads: the generators are GIL-bound Python, and
        the training loop is host-launch bound. A consumer thread receives
        the batches and calls :meth:`_swap_rows`. The children are spawned
        and import only numpy-level code, never CUDA; a producer that dies
        is restarted, at most 5 times in all (:class:`._producers.ProducerPool`)."""
        from . import _producers

        specs = [(_producers.carve_producer,
                  (self.L, self.M, self._rng.randint(0, 2**31 - 1), batch_per_cycle))
                 for _ in range(n_threads)]
        if forward:
            specs.append((_producers.forward_producer,
                          (self.L, self.M, self.parity_translate, forward_seed_start,
                           forward_window, self._rng.randint(0, 2**31 - 1))))
        self._stop.clear()
        self._pool = _producers.ProducerPool(specs)
        th = threading.Thread(target=self._consume, daemon=True)
        th.start()
        self._threads.append(th)

    def stop_refresh(self) -> None:
        """Stop the consumer thread, then the producers (drain, join,
        terminate what still runs); no process outlives this call."""
        self._stop.set()
        for th in self._threads:
            th.join(timeout=30)
        self._threads.clear()
        if self._pool is not None:
            self._pool.close()

    # -- views ------------------------------------------------------------------

    @property
    def family_counts(self) -> dict:
        """How many rows come from each generator family."""
        return {"carve": int((self.family == FAMILY_CARVE).sum()),
                "forward": int((self.family == FAMILY_FORWARD).sum())}

    def subset(self, family: int) -> Optional["ConfigBank"]:
        """A new bank of this family's rows (None if there are none), for
        per-family evaluation."""
        idx = np.flatnonzero(self.family == family)
        if len(idx) == 0:
            return None
        sel = torch.as_tensor(idx, device=self.device)
        cols, pieces = self.rows
        return ConfigBank.from_rows(self.L, self.M, cols[sel], pieces[sel],
                                    self.family[idx])

    def row_keys(self) -> set[bytes]:
        """One key per row, the (board, piece-sequence) identity; used to
        prove train/holdout disjointness."""
        cols, pieces = self.rows
        boards = unpack_board(cols).cpu().numpy()
        return {_row_key(b, p) for b, p in zip(boards, pieces.cpu().numpy())}

    @classmethod
    def from_rows(cls, L: int, M: int, cols: torch.Tensor,
                  pieces: torch.Tensor,
                  family: Optional[np.ndarray] = None) -> "ConfigBank":
        """A bank holding given rows (checkpoint restore, subsets); rows
        without a ``family`` are carve-family."""
        bank = cls(L, M, capacity=cols.shape[0], device=cols.device)
        bank.rows = (cols.to(torch.int32).contiguous(),
                     pieces.to(torch.int8).contiguous())
        if family is not None:
            bank.family[:] = family
        return bank


def make_holdout_bank(
    L: int,
    M: int,
    capacity: int,
    train_bank: Optional[ConfigBank] = None,
    *,
    seed: int = 1_000_003,
    forward_fraction: float = 0.5,
    forward_seed_start: int = 100_000,
    forward_seed_budget: int = 4_000,
    forward_time_budget_s: float = 120.0,
    device="cuda",
) -> ConfigBank:
    """An evaluation bank checked to be disjoint from ``train_bank``.

    Rows, in this order (``tetris_piclim_tpu.gen.bank.make_holdout_bank``):

    * host forward games proven by the DFS solver, from seeds >=
      ``forward_seed_start`` (training banks never use them), bounded by
      ``forward_seed_budget`` seeds and ``forward_time_budget_s`` seconds,
      up to ``capacity * forward_fraction`` rows; these rows are the JAX
      bank's, word for word;
    * where the host falls short (on hard tasks its yield collapses), up to
      8 chunks of device forward rows from the beam prover under a
      holdout-only generator seeded with ``seed``;
    * device carves from the same generator for the rest.

    Every row that collides with a training row (or an earlier holdout row)
    is dropped, and disjointness is checked at the end. The bank's
    ``provenance`` says where its rows came from: ``host_forward`` and
    ``device_forward`` rows, the ``host_seeds`` the DFS solver tried, the
    beam prover's yield (``beam_chunks`` run, ``beam_candidates`` drawn,
    ``beam_winners`` proven, before the dedup and the cut to the share),
    and the build's ``seconds``."""
    t_start = time.monotonic()
    bank = ConfigBank(L, M, capacity=capacity, seed=seed, device=device)
    dev, P = bank.device, bank.P
    taken = train_bank.row_keys() if train_bank is not None else set()
    rows: list[tuple[np.ndarray, np.ndarray]] = []

    def add(board: np.ndarray, pieces: np.ndarray) -> None:
        k = _row_key(board, pieces)
        if k not in taken:
            taken.add(k)
            rows.append((board, pieces))

    n_forward = int(capacity * forward_fraction)
    s = forward_seed_start
    t_end = time.monotonic() + forward_time_budget_s
    while (len(rows) < n_forward
           and s < forward_seed_start + forward_seed_budget
           and time.monotonic() < t_end):
        games = generate_batch(L, M, seed_start=s, seed_end=s + 100)
        s += 100
        for b, p in translate_batch(games, M, rng=bank._rng, parity=False):
            if len(rows) >= n_forward:
                break
            add(np.asarray(b, dtype=bool),
                np.asarray((p + [0] * P)[:P], dtype=np.int8))
    n_host = len(rows)

    gen = torch.Generator(device=dev).manual_seed(seed)
    beam = {"beam_candidates": 0, "beam_winners": 0, "beam_chunks": 0}
    for _ in range(8):
        if len(rows) >= n_forward:
            break
        fb = device_forward.generate_batch_device(
            _fwd_chunk_for(n_forward), L, M, generator=gen, device=dev)
        win = fb.winnable.nonzero()[:, 0]
        beam["beam_chunks"] += 1
        beam["beam_candidates"] += fb.winnable.numel()
        beam["beam_winners"] += win.numel()
        boards = unpack_board(fb.boards[win]).cpu().numpy()
        pieces = fb.pieces[win].cpu().numpy()
        for b, p in zip(boards, pieces):
            if len(rows) >= n_forward:
                break
            add(b, p)
    n_forward_got = len(rows)

    while len(rows) < capacity:
        batch = device_carver.generate_batch_device(
            max(64, capacity - len(rows)), L, M, generator=gen, device=dev)
        boards = unpack_board(batch.boards).cpu().numpy()
        pieces = batch.pieces.cpu().numpy()
        for b, p in zip(boards, pieces):
            if len(rows) >= capacity:
                break
            add(b, p)

    cols, pieces = pack_host_rows(rows, P)
    bank.rows = (cols.to(dev), pieces.to(dev))
    bank.family[:n_forward_got] = FAMILY_FORWARD
    if train_bank is not None:
        overlap = bank.row_keys() & train_bank.row_keys()
        if overlap:
            raise RuntimeError(f"holdout/train overlap: {len(overlap)} rows")
    bank.provenance = {"host_forward": n_host, "device_forward": n_forward_got - n_host,
                       "carve": capacity - n_forward_got,
                       "host_seeds": s - forward_seed_start, **beam,
                       "seconds": time.monotonic() - t_start}
    return bank
