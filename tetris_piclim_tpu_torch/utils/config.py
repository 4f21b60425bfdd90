"""Configuration dataclasses — every knob the reference hardcodes, surfaced.

A copy of ``tetris_piclim_tpu/utils/config.py`` (same fields and defaults,
so a config JSON serves both packages). ``bank_carve_fraction`` sets the
trainer's default host bank, as in JAX. ``EnvConfig.parity_translate`` is
read by neither trainer; ``ConfigBank`` and ``env_api.Tetris`` take the
parity mode as an argument.

The reference scatters its configuration across constructor kwargs
(game/tetris.py:141), a "MODIFIABLE PARAMETERS" block
(game/tetris_algo_main/main.py:35-42) and module constants
(model/train.py:15-21). Here it is one typed tree, serializable to/from JSON.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class EnvConfig:
    """Tetris-piclim task parameters (reference game/tetris.py:141)."""

    L: int = 2                  # lines to clear
    M: int = 20                 # move budget
    # reward shaping (the reference defines no reward at all — the trainer
    # stub never got that far; decide-and-document):
    reward_per_line: float = 1.0
    win_reward: float = 10.0
    loss_reward: float = -10.0

    # forward-generator pipeline knobs (reference main.py:35-42)
    initial_height_max: int = 4
    seed_start: int = 0
    seed_end: int = 100
    max_attempts: int = 1000
    # reproduce the reference's prepended-random-first-piece quirk
    # (game/tetris.py:19-20)?
    parity_translate: bool = False


@dataclass(frozen=True)
class DQNConfig:
    """Hyperparameters declared at reference model/train.py:15-21."""

    batch_size: int = 128       # BATCH_SIZE
    gamma: float = 0.99         # GAMMA
    eps_start: float = 0.9      # EPS_START
    eps_end: float = 0.05       # EPS_END
    eps_decay: float = 1000.0   # EPS_DECAY (exponential decay constant)
    tau: float = 0.005          # TAU — Polyak target update rate
    lr: float = 1e-4            # LR — AdamW(amsgrad) (train.py:27)
    weight_decay: float = 1e-2  # torch AdamW default
    double_dqn: bool = True     # reduces overestimation; off → vanilla DQN
    huber_delta: float = 1.0
    # store AdamW moment state (m, v, v_max) in bfloat16
    opt_state_bf16: bool = False
    # extensions beyond the reference's declared algorithm (each default-off
    # so the reference-spec hyperparameters above stand alone):
    n_step: int = 1             # n-step returns (1 = the reference's 1-step TD)
    prioritized: bool = False   # proportional prioritized replay (PER)
    per_alpha: float = 0.6      # priority exponent
    per_beta: float = 0.4       # initial importance-sampling exponent
    per_beta_anneal: bool = True  # anneal beta -> 1 over training (Schaul)
    per_beta_steps: int = 0     # anneal horizon; 0 = the run's total_steps
    per_eps: float = 1e-3       # priority floor added to |td|


@dataclass(frozen=True)
class TrainConfig:
    env: EnvConfig = field(default_factory=EnvConfig)
    dqn: DQNConfig = field(default_factory=DQNConfig)

    # fused-actor kernel: K>0 runs the fused actor kernel (ops/actor.py) for
    # K env steps per learner phase (obs+Q-forward+eps-greedy+step+reset in
    # one launch; requires the plain MLP QNetwork, non-dueling). The policy
    # is frozen for K steps between update phases. 0 = the per-step actor.
    actor_fusion: int = 0
    num_envs: int = 1024        # vmapped envs stepped in lockstep
    bank_capacity: int = 1024   # device-resident winnable configs
    # default bank family mix: 75% carved + 25% forward generate+prove —
    # both reference producers (game/tetris.py:473-488) feed training, not
    # just the carver. 1.0 = carve-only.
    bank_carve_fraction: float = 0.75
    replay_capacity: int = 131072
    warmup_steps: int = 1000    # env steps before learning starts
    updates_per_step: int = 1   # learner updates per env step
    total_steps: int = 100_000  # outer env steps
    log_every: int = 1000
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0   # 0 = disabled
    # demonstration-augmented training: every demo_every chunks,
    # refresh a persistent demo replay buffer with transitions from PROVEN
    # winning trajectories (the beam prover's recorded solutions,
    # gen/device_forward.py rotations/locations) and draw demo_ratio of every
    # learner batch from it. 0 = off. The buffer lives OUTSIDE TrainState,
    # so checkpoints stay resume-compatible either way.
    demo_every: int = 0
    demo_ratio: float = 0.25
    demo_rows: int = 1024       # prover candidates per refresh
    demo_capacity: int = 8192   # demo buffer transitions (full rewrite/refresh)
    demo_margin: float = 0.0    # DQfD large-margin coefficient (0 = TD only)
    demo_margin_weight: float = 1.0  # weight of the margin term in the loss

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "TrainConfig":
        raw = json.loads(text)
        return TrainConfig(
            env=EnvConfig(**raw.get("env", {})),
            dqn=DQNConfig(**raw.get("dqn", {})),
            **{
                k: v
                for k, v in raw.items()
                if k not in ("env", "dqn")
            },
        )
