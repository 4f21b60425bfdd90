"""The TPU-trained L=2/M=20 policy, carried out of its orbax checkpoint into
two small numpy files that the port reads without JAX.

    git archive b5c6e5a results/ckpt_L2M20_v2 | tar -x -C DIR
    JAX_PLATFORMS=cpu python3 tools/tpu_checkpoint.py DIR/results/ckpt_L2M20_v2

The checkpoint is the final train state of the JAX package's first DQN run
(L=2/M=20, 4096 envs, 100k steps on a TPU; ``results/train_L2M20_v2_summary.json``,
greedy win rate 0.5632 there). Commit ``b5c6e5a`` added it and a later one
stopped tracking it, so it lives only in git history, 14 MB; ``DIR`` is any
directory outside the repo tree. (Two more lie in history the same way:
``results/ckpt_L2M20`` at ``7b4582a`` and ``results/ckpt_L2M20_long``.)

This tool imports JAX and runs on the CPU. It reads the checkpoint through
the JAX package's own ``utils/checkpoint.py::restore_params`` and writes:

- ``results/tpu_L2M20_v2_params.npz``: the online and target parameters of
  the 217 -> 4x128 -> 14 MLP under their paths in the train state
  (``params/params/Dense_0/kernel``, ...,
  ``target_params/params/Dense_4/bias``), float32;
- ``results/tpu_L2M20_v2_eval.npz``: the 4096 rows of
  ``ConfigBank(2, 20, capacity=4096, seed=0).fill_device()`` (``boards``
  bool[4096, 20, 10], ``pieces`` int8[4096, 21]), the 4096 row indices that
  ``DQNTrainer.evaluate`` draws from ``PRNGKey(seed + 1)`` (``idx``), and
  the JAX package's greedy result on them with these weights: each
  episode's final status (``status``: 1 won, 2 lost) and the win rate
  (``win_rate``).

The port reads the first with ``utils/checkpoint.py::load_flax_npz`` and
replays the second through its own ``make_state_batch`` and
``greedy_rollout`` (``tests/test_torch_tpu_weights.py``, ``chip_smoke.py``).
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PARAMS = ROOT / "results" / "tpu_L2M20_v2_params.npz"
EVAL = ROOT / "results" / "tpu_L2M20_v2_eval.npz"


def flat(tree, prefix: str) -> dict:
    """``{"prefix/Dense_0/kernel": array, ...}`` of a nested flax dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, dtype=np.float32)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", help="the orbax train-state directory")
    p.add_argument("--params-out", default=str(PARAMS))
    p.add_argument("--eval-out", default=str(EVAL))
    p.add_argument("--episodes", type=int, default=4096)
    a = p.parse_args(argv)

    import jax

    from tetris_piclim_tpu.dqn.train import DQNTrainer
    from tetris_piclim_tpu.gen.bank import ConfigBank
    from tetris_piclim_tpu.utils.config import EnvConfig, TrainConfig

    cfg = TrainConfig(env=EnvConfig(L=2, M=20), num_envs=64, bank_capacity=4096,
                      replay_capacity=1024, seed=0)
    bank = ConfigBank(2, 20, capacity=4096, seed=0).fill_device()
    tr = DQNTrainer(cfg, bank=bank)
    tr.warm_start(str(Path(a.checkpoint).resolve()))
    params = {**flat(jax.device_get(tr.state.params), "params"),
              **flat(jax.device_get(tr.state.target_params), "target_params")}

    ev = tr.evaluate(n_episodes=a.episodes)
    key = jax.random.PRNGKey(cfg.seed + 1)
    # evaluate()'s own draw and rollout, kept to read each episode's status
    idx = np.asarray(jax.random.randint(key, (a.episodes,), 0, bank.boards.shape[0]))
    final = tr._eval_runs[a.episodes](tr.state.params, bank.boards, bank.pieces, key)
    status = np.asarray(final.status).astype(np.int8)
    if float((status == 1).mean()) != ev["win_rate"]:
        raise SystemExit("the per-episode status disagrees with evaluate()")

    np.savez_compressed(a.params_out, **params)
    np.savez_compressed(a.eval_out, boards=np.asarray(bank.boards, dtype=bool),
                        pieces=np.asarray(bank.pieces, dtype=np.int8),
                        idx=idx.astype(np.int32), status=status,
                        win_rate=np.float64(ev["win_rate"]))
    print(json.dumps({"tool": "tpu_checkpoint", "checkpoint": a.checkpoint,
                      "params": a.params_out, "eval": a.eval_out,
                      "episodes": a.episodes, "win_rate": ev["win_rate"],
                      "params_bytes": Path(a.params_out).stat().st_size,
                      "eval_bytes": Path(a.eval_out).stat().st_size}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
