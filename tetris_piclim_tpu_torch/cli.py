"""Command-line interface of the PyTorch port: ``train`` and ``eval``.

Usage: ``python -m tetris_piclim_tpu_torch <command> [flags]``. The flags
are those of ``tetris_piclim_tpu.cli`` for the ported path, plus
``--device {cuda,cpu}`` (default cuda; there is no silent CPU fallback).
"""

from __future__ import annotations

import argparse
import json
import sys


def _config(args):
    from .utils.config import DQNConfig, EnvConfig, TrainConfig

    if args.smoke:
        return TrainConfig(
            env=EnvConfig(L=1, M=8),
            num_envs=64, bank_capacity=64, replay_capacity=8192,
            warmup_steps=256, total_steps=400, log_every=100, seed=args.seed,
            actor_fusion=args.actor_fusion,
            checkpoint_dir=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
        )
    return TrainConfig(
        env=EnvConfig(L=args.lines, M=args.moves),
        dqn=DQNConfig(eps_decay=args.eps_decay, double_dqn=args.double,
                      batch_size=args.batch, lr=args.lr),
        num_envs=args.num_envs,
        bank_capacity=args.bank,
        replay_capacity=args.replay,
        warmup_steps=args.warmup,
        total_steps=args.steps,
        log_every=args.log_every,
        updates_per_step=args.updates,
        actor_fusion=args.actor_fusion,
        seed=args.seed,
        checkpoint_dir=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
    )


def _net(joint: bool, seed: int):
    import torch

    from .models.qnet import QNetwork

    return QNetwork(joint=joint, generator=torch.Generator().manual_seed(seed))


def _parse_height(spec: str) -> tuple[int, int]:
    """'4' -> (4, 4); '8:4' -> (8, 4), an initial_height_max anneal."""
    parts = spec.split(":")
    if len(parts) in (1, 2):
        return (int(parts[0]), int(parts[-1]))
    raise ValueError(f"bad --device-height {spec!r}; want H or H0:H1")


def _device_bank(args, L: int, M: int, capacity: int, seed: int):
    """The bank ``--device-bank`` asks for: carves plus a ``--device-forward``
    share of beam-proven forward rows at height H0."""
    from .gen.bank import ConfigBank

    return ConfigBank(L, M, capacity=capacity, seed=seed,
                      device=args.device).fill_device(
        forward_fraction=args.device_forward, beam_width=args.device_beam,
        initial_height_max=_parse_height(args.device_height)[0])


def _holdout_eval(args, trainer, episodes: int) -> dict:
    """Greedy results on a held-out bank disjoint from the trainer's bank,
    in all and per family."""
    from .gen.bank import FAMILY_CARVE, FAMILY_FORWARD, make_holdout_bank

    cfg = trainer.cfg
    holdout = make_holdout_bank(cfg.env.L, cfg.env.M,
                                capacity=args.holdout_bank,
                                train_bank=trainer.bank, device=args.device)
    out = {"holdout": trainer.evaluate(n_episodes=episodes, bank=holdout)}
    out["holdout"]["families"] = holdout.family_counts
    for name, fam in (("carve", FAMILY_CARVE), ("forward", FAMILY_FORWARD)):
        sub = holdout.subset(fam)
        if sub is not None:
            out[f"holdout_{name}"] = trainer.evaluate(n_episodes=episodes,
                                                      bank=sub)
    return out


def cmd_train(args) -> int:
    from .dqn.train import DQNTrainer
    from .utils.checkpoint import save_bank, save_train_state
    from .utils.metrics import MetricsLogger

    cfg = _config(args)
    height = _parse_height(args.device_height)
    if args.device_refresh == 0 and height[0] != height[1]:
        print("warning: --device-height H0:H1 has no effect without "
              "--device-refresh K > 0 (the height applies only when bank "
              "rows are regenerated)", file=sys.stderr)
    bank = None
    if args.device_bank:
        bank = _device_bank(args, cfg.env.L, cfg.env.M, cfg.bank_capacity,
                            cfg.seed)
    trainer = DQNTrainer(cfg, bank=bank, net=_net(args.joint, cfg.seed),
                         device=args.device)
    logger = MetricsLogger(path=args.log_file)
    trainer.train(log_fn=lambda msg: print(msg, file=sys.stderr),
                  device_refresh_every=args.device_refresh,
                  device_forward_fraction=args.device_forward,
                  device_beam_width=args.device_beam,
                  device_height=height)
    if args.checkpoint:
        final = (f"{args.checkpoint}/final" if args.checkpoint_every > 0
                 else args.checkpoint)
        save_train_state(final, trainer.state)
        save_bank(final, trainer.bank)
        print(f"checkpoint saved to {final}", file=sys.stderr)
    ev = {"train_bank": trainer.evaluate(n_episodes=args.eval_episodes)}
    if args.eval_holdout:
        ev.update(_holdout_eval(args, trainer, args.eval_episodes))
    logger.log({"final_eval": ev})
    print(json.dumps(ev))
    logger.close()
    return 0


def cmd_eval(args) -> int:
    from .dqn.train import DQNTrainer
    from .utils.config import EnvConfig, TrainConfig

    cfg = TrainConfig(env=EnvConfig(L=args.lines, M=args.moves), num_envs=64,
                      bank_capacity=args.bank, replay_capacity=8192,
                      seed=args.seed)
    bank = None
    if args.restore_bank:
        # the live rows a training run saved with its final checkpoint: the
        # only faithful bank of a --device-refresh run
        from .utils.checkpoint import restore_bank

        bank = restore_bank(args.restore_bank, args.device)
        if (bank.L, bank.M) != (args.lines, args.moves):
            print(f"--restore-bank task (L={bank.L}, M={bank.M}) does not "
                  f"match -L {args.lines} -M {args.moves}", file=sys.stderr)
            return 2
    elif args.device_bank:
        # the training run's INITIAL fill (same seed, capacity, forward
        # share, beam and height)
        bank = _device_bank(args, args.lines, args.moves, args.bank, args.seed)
    trainer = DQNTrainer(cfg, bank=bank, net=_net(args.joint, args.seed),
                         device=args.device)
    if args.checkpoint:
        trainer.warm_start(args.checkpoint)
    out = {"bank": trainer.evaluate(n_episodes=args.episodes)}
    if args.eval_holdout:
        out.update(_holdout_eval(args, trainer, args.episodes))
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tetris_piclim_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    def common(p, bank_default: int) -> None:
        p.add_argument("-L", "--lines", type=int, default=2, help="lines to clear")
        p.add_argument("-M", "--moves", type=int, default=20, help="move budget")
        p.add_argument("--bank", type=int, default=bank_default)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--joint", action="store_true",
                       help="40-way joint (rotation, column) head")
        p.add_argument("--device-bank", action="store_true",
                       help="fill the config bank on the device (carver, "
                            "plus --device-forward proven forward rows)")
        p.add_argument("--device-forward", type=float, default=0.0,
                       metavar="F",
                       help="share of the device bank generated as forward "
                            "games proven by the beam prover; applies to "
                            "the fill and to --device-refresh")
        p.add_argument("--device-beam", type=int, default=8, metavar="K",
                       help="beam width of the device prover (1 = greedy)")
        p.add_argument("--device-height", default="4", metavar="H0[:H1]",
                       help="forward prefill height cap; H0:H1 anneals it "
                            "over the run (the fill uses H0)")
        p.add_argument("--eval-holdout", action="store_true",
                       help="also evaluate on a held-out bank checked to be "
                            "disjoint from the training bank")
        p.add_argument("--holdout-bank", type=int, default=1024,
                       help="held-out bank capacity for --eval-holdout")
        p.add_argument("--checkpoint")
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    p = sub.add_parser("train", help="run the DQN actor-learner")
    common(p, 1024)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--replay", type=int, default=131072)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--log-every", type=int, default=1000)
    p.add_argument("--updates", type=int, default=1,
                   help="learner updates per env step")
    p.add_argument("--actor-fusion", type=int, default=0, metavar="K",
                   help="run the fused actor kernel for K env steps per "
                        "learner phase (0 = per-step actor)")
    p.add_argument("--eps-decay", type=float, default=1000.0)
    p.add_argument("--double", action=argparse.BooleanOptionalAction,
                   default=True, help="double DQN target")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--eval-episodes", type=int, default=1024)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also checkpoint every N outer steps into "
                        "<checkpoint>/step_<n> (0 = final only)")
    p.add_argument("--device-refresh", type=int, default=0, metavar="K",
                   help="regenerate the bank on the device every K chunks "
                        "(carve rows only unless --device-forward > 0)")
    p.add_argument("--log-file", help="JSONL metrics path")
    p.add_argument("--smoke", action="store_true", help="tiny smoke run")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="greedy-policy win rate")
    common(p, 256)
    p.add_argument("--episodes", type=int, default=1024)
    p.add_argument("--restore-bank", metavar="CKPT",
                   help="evaluate on the live bank rows a training run saved "
                        "with its checkpoint instead of rebuilding the bank")
    p.set_defaults(fn=cmd_eval)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
