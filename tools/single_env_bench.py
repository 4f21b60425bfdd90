"""Single-env API move throughput, the harness of
``benchmarks/bench_single_env.py``.

    python3 tools/single_env_bench.py [--moves 20000]

Random moves with auto-reset through the port's drop-in ``env_api.Tetris``
(L=2/M=20, warm reset from its producer processes, seed 0). The single-env
class steps on the host (numpy), so this needs no card. Prints one JSON
line; ``reference_1core`` is the reference's single-core ``move()`` rate
(BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tetris_piclim_tpu_torch.env_api import Tetris  # noqa: E402


def run(n_moves: int = 20_000) -> dict:
    rng = random.Random(0)
    t = Tetris(2, 20, warm_reset=True, seed=0)
    try:
        t.move(0, 0)
        t.reset()
        t0 = time.perf_counter()
        for _ in range(n_moves):
            t.move(rng.randint(0, 3), rng.randint(0, 9))
            if t.state is not None:
                t.reset()
        dt = time.perf_counter() - t0
    finally:
        t.terminate()
    return {
        "bench": "single_env_api_moves_per_s",
        "value": round(n_moves / dt, 1),
        "moves": n_moves,
        "reference_1core": 49000.0,
        "note": "host numpy single-env path; the batched engines step on the card",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--moves", type=int, default=20_000)
    print(json.dumps(run(ap.parse_args(argv).moves)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
