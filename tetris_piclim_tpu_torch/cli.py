"""Command-line interface of the PyTorch port: ``train`` and ``eval``.

Usage: ``python -m tetris_piclim_tpu_torch <command> [flags]``. The flags
are those of ``tetris_piclim_tpu.cli`` for the ported path, plus
``--device {cuda,cpu}`` (default cuda; there is no silent CPU fallback).
``train --smoke`` shrinks the sizes (task L=1/M=8, 64 envs, bank 64, replay
8192, 400 steps, at most 64 demo rows into a 512-row demo buffer) and keeps
every other flag.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _config(args):
    from .utils.config import DQNConfig, EnvConfig, TrainConfig

    cfg = TrainConfig(
        env=EnvConfig(L=args.lines, M=args.moves),
        dqn=DQNConfig(n_step=args.n_step, prioritized=args.per,
                      eps_decay=args.eps_decay, double_dqn=args.double,
                      batch_size=args.batch, lr=args.lr,
                      opt_state_bf16=args.opt_bf16),
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
        demo_every=args.demo_every,
        demo_ratio=args.demo_ratio,
        demo_rows=args.demo_rows,
        demo_margin=args.demo_margin,
        demo_margin_weight=args.demo_margin_weight,
    )
    if args.smoke:
        cfg = dataclasses.replace(
            cfg, env=EnvConfig(L=1, M=8), num_envs=64, bank_capacity=64,
            replay_capacity=8192, warmup_steps=256, total_steps=400,
            log_every=100, demo_rows=min(cfg.demo_rows, 64), demo_capacity=512)
    return cfg


def _net(args, seed: int):
    """The Q-network the flags ask for (JAX ``cli._build_net``): the MLP,
    or with ``--model conv`` the conv torso; ``--dueling`` and ``--joint``
    on either, ``--bf16`` the conv torso's compute dtype."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if args.model == "conv":
        from .models.convnet import ConvQNetwork

        return ConvQNetwork(
            channels=tuple(int(c) for c in args.channels.split(",")),
            dueling=args.dueling, joint=args.joint,
            dtype=torch.bfloat16 if args.bf16 else torch.float32,
            impl=args.conv_impl, bottleneck=args.bottleneck, pool=args.pool,
            generator=gen)
    from .models.qnet import QNetwork

    return QNetwork(joint=args.joint, dueling=args.dueling, generator=gen)


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
    if args.device_refresh == 0 and (args.adaptive_share or height[0] != height[1]):
        print("warning: --adaptive-share / --device-height H0:H1 have no "
              "effect without --device-refresh K > 0 (the share and the "
              "height apply only when bank rows are regenerated)",
              file=sys.stderr)
    bank = None
    if args.device_bank:
        bank = _device_bank(args, cfg.env.L, cfg.env.M, cfg.bank_capacity,
                            cfg.seed)
    trainer = DQNTrainer(cfg, bank=bank, net=_net(args, cfg.seed),
                         device=args.device)
    if args.warm_start:
        trainer.warm_start(args.warm_start)
        print(f"warm-started weights from {args.warm_start}", file=sys.stderr)
    if args.resume:
        trainer.restore_checkpoint(args.resume)
        print(f"resumed from {args.resume} at step "
              f"{trainer.state.global_step}", file=sys.stderr)
    logger = MetricsLogger(path=args.log_file)
    trainer.train(log_fn=lambda msg: print(msg, file=sys.stderr),
                  device_refresh_every=args.device_refresh,
                  device_forward_fraction=args.device_forward,
                  device_beam_width=args.device_beam,
                  device_height=height,
                  adaptive_share=args.adaptive_share,
                  adapt_every=args.adapt_every,
                  adapt_rule=args.adapt_rule)
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
    trainer = DQNTrainer(cfg, bank=bank, net=_net(args, args.seed),
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
        p.add_argument("--model", choices=["mlp", "conv"], default="mlp",
                       help="mlp = the reference's 4x128 MLP; conv = the "
                            "conv torso (models/convnet.py)")
        p.add_argument("--dueling", action="store_true",
                       help="dueling value/advantage head (either model)")
        p.add_argument("--bf16", action="store_true",
                       help="bfloat16 compute in the conv torso (parameters "
                            "and the Q head stay float32)")
        p.add_argument("--conv-impl", choices=["conv", "im2col"],
                       default="conv",
                       help="which JAX parameter tree the conv net mirrors; "
                            "the port computes both with F.conv2d")
        p.add_argument("--bottleneck", type=int, default=0, metavar="C",
                       help="conv model: 1x1 conv to C channels before the "
                            "flatten (0 = none)")
        p.add_argument("--pool", type=int, default=1, metavar="P",
                       help="conv model: PxP max-pool before the flatten")
        p.add_argument("--channels", default="32,64", metavar="C1,C2",
                       help="conv torso channel widths")
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
    p.add_argument("--n-step", type=int, default=1,
                   help="n-step returns (1 = the reference's 1-step TD)")
    p.add_argument("--per", action="store_true",
                   help="prioritized replay (proportional, importance "
                        "weights annealed to 1 over --steps)")
    p.add_argument("--opt-bf16", action="store_true",
                   help="store the AdamW moments (m, v, v_max) in bfloat16")
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
    p.add_argument("--demo-every", type=int, default=0, metavar="K",
                   help="every K chunks rebuild a demonstration buffer from "
                        "the beam prover's proven solutions and draw "
                        "--demo-ratio of every batch from it (0 = off)")
    p.add_argument("--demo-ratio", type=float, default=0.25,
                   help="share of each learner batch from the demo buffer")
    p.add_argument("--demo-rows", type=int, default=1024,
                   help="forward candidates proven per demo refresh")
    p.add_argument("--demo-margin", type=float, default=0.0,
                   help="DQfD large-margin coefficient on demo rows "
                        "(0 = TD only)")
    p.add_argument("--demo-margin-weight", type=float, default=1.0,
                   help="weight of the margin term in the loss")
    p.add_argument("--adaptive-share", action="store_true",
                   help="every --adapt-every chunks, set the forward share "
                        "of the refreshed bank from greedy win rates on two "
                        "probe banks (one per family)")
    p.add_argument("--adapt-every", type=int, default=20, metavar="K",
                   help="chunks between adaptive-share probe evaluations")
    p.add_argument("--adapt-rule", choices=["v1", "v2"], default="v2",
                   help="v1 = failure-rate proportional; v2 = anchored at "
                        "the 0.25 prior, raised only while the forward "
                        "probe is below half the carve probe")
    p.add_argument("--resume", help="restore a training checkpoint and go on "
                                    "training (same config shape)")
    p.add_argument("--warm-start", help="load only the network weights of a "
                                        "checkpoint (same architecture)")
    p.add_argument("--log-file", help="JSONL metrics path")
    p.add_argument("--smoke", action="store_true",
                   help="tiny sizes (see the module docstring)")
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
