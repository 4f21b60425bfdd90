"""Device-resident bank of winnable start configurations (carve family).

Counterpart of the device half of ``tetris_piclim_tpu/gen/bank.py``: the
bank keeps B winnable (board, piece-sequence) rows in device memory, and
the env auto-reset draws rows from it with no host involvement. Rows come
from the lockstep carver (:mod:`.device_carver`); ``refresh_device``
regenerates them between training chunks so the training distribution is
effectively infinite.

Boards are kept packed (int32[B, 10] column words, the layout the step and
the kernels read); the JAX bank keeps bool[B, 20, 10] and packs per chunk.
Not ported yet (ROADMAP.md): the device-forward family with its beam prover
(``forward_fraction > 0``), the host generators and their async refresh,
and the held-out bank.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.device import resolve_device
from .device_carver import generate_batch_device


def _no_forward(forward_fraction: float) -> None:
    if forward_fraction > 0:
        raise NotImplementedError(
            "device-forward bank rows (the beam prover) are not ported yet "
            "(ROADMAP.md, queue A)"
        )


class ConfigBank:
    """Fixed-capacity bank: ``cols`` int32[B, 10] and ``pieces`` int8[B, M+1]
    on ``device``."""

    def __init__(self, L: int, M: int, capacity: int = 1024, seed: int = 0,
                 device="cuda"):
        self.L, self.M = L, M
        self.capacity = capacity
        self.P = M + 1
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cols: Optional[torch.Tensor] = None
        self.pieces: Optional[torch.Tensor] = None

    def _carve(self, seed: Optional[int]) -> None:
        gen = self._gen if seed is None else (
            torch.Generator(device=self.device).manual_seed(seed))
        batch = generate_batch_device(
            self.capacity, self.L, self.M, generator=gen, device=self.device)
        self.cols, self.pieces = batch.boards, batch.pieces

    def fill_device(self, seed: Optional[int] = None,
                    forward_fraction: float = 0.0) -> "ConfigBank":
        """Fill every row with carved configurations, on the device."""
        _no_forward(forward_fraction)
        self._carve(seed)
        return self

    def refresh_device(self, seed: Optional[int] = None,
                       forward_fraction: float = 0.0) -> "ConfigBank":
        """Regenerate every (carve-family) row with fresh configurations;
        ``seed`` starts a fresh stream, None continues the bank's own."""
        _no_forward(forward_fraction)
        self._carve(seed)
        return self

    @classmethod
    def from_rows(cls, L: int, M: int, cols: torch.Tensor,
                  pieces: torch.Tensor) -> "ConfigBank":
        """A bank holding given rows (checkpoint restore)."""
        bank = cls(L, M, capacity=cols.shape[0], device=cols.device)
        bank.cols = cols.to(torch.int32).contiguous()
        bank.pieces = pieces.to(torch.int8).contiguous()
        return bank
