"""7-bag piece randomizer (host) and batched 7-bag sequences (device).

Counterpart of ``tetris_piclim_tpu/gen/bag.py``. ``SevenBag`` is the
reference's ``RandomPieceGenerator`` (game/tetris.py:64-108): pieces are
drawn without replacement from a bag of the 7 tetrominoes, refilled when
empty, and ``sequence(n)`` concatenates shuffled bags.

``bag_sequences_device`` draws N independent 7-bag sequences at once: one
uniform key per (sequence, bag, piece), argsorted within each bag, is a
uniform permutation per bag. The JAX package permutes each bag under its own
threefry key; the streams differ, the distribution is the same.

The module imports torch only inside ``bag_sequences_device``: the host
carver (:mod:`.carver`) uses ``SevenBag`` in the producer processes of
``ConfigBank.start_refresh`` and ``env_api``, which load no torch.
"""

from __future__ import annotations

import random as _random_module


class SevenBag:
    """Draws report ``(piece, index, refilled)``; a consumer that rejects the
    piece may leave it in the bag (``remove`` is explicit, like the
    reference's ``delete_index``, game/tetris.py:88-89)."""

    def __init__(self, rng=None) -> None:
        self.rng = rng if rng is not None else _random_module
        self.pieces: list[int] = []

    def refill(self) -> None:
        self.pieces = list(range(7))

    def draw(self) -> tuple[int, int, bool]:
        refilled = False
        if not self.pieces:
            self.refill()
            refilled = True
        idx = self.rng.randint(0, len(self.pieces) - 1)
        return self.pieces[idx], idx, refilled

    def remove(self, idx: int) -> None:
        del self.pieces[idx]

    def sequence(self, length: int) -> list[int]:
        """Concatenated shuffled bags, truncated to ``length``; a non-empty
        current bag is shuffled and consumed first (reference
        game/tetris.py:91-102, the partial first bag included)."""
        out: list[int] = []
        while len(out) < length:
            if not self.pieces:
                self.refill()
            self.rng.shuffle(self.pieces)
            out.extend(self.pieces[: min(length - len(out), 7)])
            self.pieces = []
        return out

    def __len__(self) -> int:
        return len(self.pieces)


def bag_sequences_device(n: int, length: int, *, generator: torch.Generator,
                         device) -> torch.Tensor:
    """int8[n, length]: N independent 7-bag sequences, on ``device``."""
    # imported here: the host carver imports this module in producer
    # processes, which stay free of torch
    import torch

    n_bags = -(-length // 7)
    keys = torch.rand((n, n_bags, 7), generator=generator, device=device)
    bags = keys.argsort(dim=-1).to(torch.int8)
    return bags.reshape(n, n_bags * 7)[:, :length].contiguous()
