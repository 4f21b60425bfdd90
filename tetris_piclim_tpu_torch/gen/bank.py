"""Device-resident bank of winnable start configurations, and the held-out
evaluation bank.

Counterpart of the device half of ``tetris_piclim_tpu/gen/bank.py``: the
bank keeps B winnable (board, piece-sequence) rows in device memory, and
the env auto-reset draws rows from it with no host involvement. Rows come
from two families: the lockstep carver (:mod:`.device_carver`) and, for a
``forward_fraction`` share, forward-family games proven winnable by the beam
prover (:mod:`.device_forward`). ``refresh_device`` regenerates rows between
training chunks so the training distribution is effectively infinite.

:func:`make_holdout_bank` builds an evaluation bank that is checked to be
disjoint from a training bank: host-proven forward games from seeds the
training banks never use (:mod:`.pipeline`), topped up by the device beam
prover, then device carves, each from a key of its own.

Boards are kept packed (int32[B, 10] column words, the layout the step and
the kernels read); the JAX bank keeps bool[B, 20, 10] and packs per chunk.
The per-row ``family`` stays on the host. Not ported yet (ROADMAP.md): the
host producer processes and their async refresh.
"""

from __future__ import annotations

import random
import time
from typing import Optional

import numpy as np
import torch

from ..ops.bitboard import pack_board, unpack_board
from ..utils.device import resolve_device
from . import device_carver, device_forward
from .pipeline import generate_batch, translate_batch

FAMILY_CARVE = 0
FAMILY_FORWARD = 1

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


class ConfigBank:
    """Fixed-capacity bank: ``cols`` int32[B, 10] and ``pieces`` int8[B, M+1]
    on ``device``, ``family`` int8[B] (FAMILY_CARVE / FAMILY_FORWARD) on the
    host."""

    def __init__(self, L: int, M: int, capacity: int = 1024, seed: int = 0,
                 device="cuda"):
        self.L, self.M = L, M
        self.capacity = capacity
        self.P = M + 1
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # host draws (the extra piece of host forward rows), as the JAX bank
        self._rng = random.Random(seed)
        self.cols: Optional[torch.Tensor] = None
        self.pieces: Optional[torch.Tensor] = None
        self.family = np.zeros(capacity, dtype=np.int8)

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        if seed is None:
            return self._gen
        return torch.Generator(device=self.device).manual_seed(seed)

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
        ``seed`` starts a fresh stream, None continues the bank's own."""
        self.cols, self.pieces, n_got = self._device_rows(
            self._generator(seed), forward_fraction, initial_height_max,
            oversample, beam_width)
        self.family[:] = FAMILY_CARVE
        self.family[:n_got] = FAMILY_FORWARD
        return self

    def refresh_device(self, seed: Optional[int] = None,
                       forward_fraction: float = 0.0,
                       initial_height_max: int = 4, oversample: int = 3,
                       beam_width: int = 8) -> "ConfigBank":
        """Regenerate rows on the device with fresh configurations.

        ``forward_fraction == 0``: the carve-family rows are regenerated and
        the forward-family rows kept. ``forward_fraction > 0``: the whole
        bank is regenerated as a carve + proven-forward mix, as by
        :meth:`fill_device`."""
        if forward_fraction > 0 or self.cols is None:
            return self.fill_device(seed, forward_fraction, initial_height_max,
                                    oversample, beam_width)
        batch = device_carver.generate_batch_device(
            self.capacity, self.L, self.M, generator=self._generator(seed),
            device=self.device)
        carve = torch.as_tensor(self.family == FAMILY_CARVE,
                                device=self.device)[:, None]
        self.cols = torch.where(carve, batch.boards, self.cols)
        self.pieces = torch.where(carve, batch.pieces, self.pieces)
        return self

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
        return ConfigBank.from_rows(self.L, self.M, self.cols[sel],
                                    self.pieces[sel], self.family[idx])

    def row_keys(self) -> set[bytes]:
        """One key per row, the (board, piece-sequence) identity; used to
        prove train/holdout disjointness."""
        boards = unpack_board(self.cols).cpu().numpy()
        pieces = self.pieces.cpu().numpy()
        return {_row_key(b, p) for b, p in zip(boards, pieces)}

    @classmethod
    def from_rows(cls, L: int, M: int, cols: torch.Tensor,
                  pieces: torch.Tensor,
                  family: Optional[np.ndarray] = None) -> "ConfigBank":
        """A bank holding given rows (checkpoint restore, subsets); rows
        without a ``family`` are carve-family."""
        bank = cls(L, M, capacity=cols.shape[0], device=cols.device)
        bank.cols = cols.to(torch.int32).contiguous()
        bank.pieces = pieces.to(torch.int8).contiguous()
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
    is dropped, and disjointness is checked at the end."""
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
        for b, p in translate_batch(games, M, rng=bank._rng):
            if len(rows) >= n_forward:
                break
            add(np.asarray(b, dtype=bool),
                np.asarray((p + [0] * P)[:P], dtype=np.int8))

    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(8):
        if len(rows) >= n_forward:
            break
        fb = device_forward.generate_batch_device(
            _fwd_chunk_for(n_forward), L, M, generator=gen, device=dev)
        win = fb.winnable.nonzero()[:, 0]
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

    bank.cols = pack_board(torch.as_tensor(np.stack([b for b, _ in rows]),
                                           device=dev))
    bank.pieces = torch.as_tensor(np.stack([p for _, p in rows]), device=dev)
    bank.family[:n_forward_got] = FAMILY_FORWARD
    if train_bank is not None:
        overlap = bank.row_keys() & train_bank.row_keys()
        if overlap:
            raise RuntimeError(f"holdout/train overlap: {len(overlap)} rows")
    return bank
