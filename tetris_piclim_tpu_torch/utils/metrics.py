"""Structured metrics logging.

The reference logs with bare prints, a debug-gated ``log.txt`` append and a
``winnable_games.csv`` (reference: game/tetris_algo_main/main.py:84-93;
game/main.py:69). Here: one JSONL stream with wall-clock timestamps plus an
in-memory history, suitable for tailing and for plotting learning curves.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    def __init__(
        self,
        path: Optional[str] = None,
        stream: Optional[IO] = None,
        echo: bool = True,
    ) -> None:
        self._fh = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stderr
        self._echo = echo
        self.history: list[dict] = []
        self._t0 = time.time()

    def log(self, row: dict) -> None:
        row = {"t": round(time.time() - self._t0, 3), **row}
        self.history.append(row)
        line = json.dumps(row)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=self._stream)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
