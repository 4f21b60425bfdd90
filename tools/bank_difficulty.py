"""How hard the port's device-carved banks are beside the JAX package's:
the TPU-trained L=2/M=20 policy's greedy win rate on each.

    JAX_PLATFORMS=cpu python3 tools/bank_difficulty.py [--seeds 0,1,2,3,4,5]

For each seed, ``ConfigBank(2, 20, capacity=4096, seed).fill_device()`` of
either package, and 4096 greedy episodes with the weights of
``results/tpu_L2M20_v2_params.npz`` (``tools/tpu_checkpoint.py``) through
each package's own ``DQNTrainer.warm_start`` and ``evaluate``; also the
mean count of filled cells per bank row. The banks come from different
random streams, so only their statistics can agree. Imports JAX and runs
on the CPU. Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tetris_piclim_tpu_torch.utils.checkpoint import read_flax_npz  # noqa: E402

PARAMS = ROOT / "results" / "tpu_L2M20_v2_params.npz"


def jax_win_rate(seed: int, capacity: int, episodes: int) -> tuple[float, float]:
    import jax
    import jax.numpy as jnp

    from tetris_piclim_tpu.dqn.train import DQNTrainer
    from tetris_piclim_tpu.gen.bank import ConfigBank
    from tetris_piclim_tpu.utils.config import EnvConfig, TrainConfig

    cfg = TrainConfig(env=EnvConfig(L=2, M=20), num_envs=64, bank_capacity=capacity,
                      replay_capacity=1024, seed=seed)
    bank = ConfigBank(2, 20, capacity=capacity, seed=seed).fill_device()
    tr = DQNTrainer(cfg, bank=bank)
    tree = jax.tree.map(jnp.asarray, read_flax_npz(str(PARAMS)))
    tr.state = tr.state._replace(params=tree["params"], target_params=tree["target_params"])
    cells = float(np.asarray(bank.boards).sum(axis=(1, 2)).mean())
    return tr.evaluate(n_episodes=episodes)["win_rate"], cells


def port_win_rate(seed: int, capacity: int, episodes: int) -> tuple[float, float]:
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.ops.bitboard import unpack_board
    from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

    cfg = TrainConfig(env=EnvConfig(L=2, M=20), num_envs=64, bank_capacity=capacity,
                      replay_capacity=1024, seed=seed)
    bank = ConfigBank(2, 20, capacity=capacity, seed=seed, device="cpu").fill_device()
    tr = DQNTrainer(cfg, bank=bank, device="cpu")
    tr.warm_start(str(PARAMS))
    cells = float(unpack_board(bank.rows[0]).sum(dim=(1, 2)).double().mean())
    return tr.evaluate(n_episodes=episodes)["win_rate"], cells


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="0,1,2,3,4,5")
    p.add_argument("--capacity", type=int, default=4096)
    p.add_argument("--episodes", type=int, default=4096)
    a = p.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        jw, jc = jax_win_rate(seed, a.capacity, a.episodes)
        tw, tc = port_win_rate(seed, a.capacity, a.episodes)
        print(json.dumps({"tool": "bank_difficulty", "seed": seed, "capacity": a.capacity,
                          "episodes": a.episodes, "jax_win_rate": jw, "port_win_rate": tw,
                          "jax_cells_per_row": jc, "port_cells_per_row": tc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
