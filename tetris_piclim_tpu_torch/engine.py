"""Engine constants shared by every layer of the port.

Status codes and the observation width of ``tetris_piclim_tpu.engine``; the
readable array engine itself is not ported (the packed bitboard step in
:mod:`.ops.bitboard` is the production path).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

RUNNING = 0
WIN = 1
LOSS = 2

OBS_DIM = 217  # 200 board + 7 cur + 7 nxt + lines-left + moves-left + status


class StepResult(NamedTuple):
    state: tuple              # the post-step PackedState (no reset)
    lines_delta: torch.Tensor  # int32[N] lines cleared by this step
    done: torch.Tensor        # bool[N] terminal after this step
    won: torch.Tensor         # bool[N]
