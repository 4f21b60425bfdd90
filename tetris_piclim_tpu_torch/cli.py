"""Command-line interface of the PyTorch port: ``train`` (the DQN loop),
``curriculum`` (the curriculum trainer), ``eval`` (greedy win rate),
``generate`` (winnable configurations, both families), ``play`` (one
episode of the single-env API) and ``bench`` (env-step throughput, and the
flagship training recipe's env-steps/s, MFU and learner share unless
``--no-train``; ``bench.py``'s keys).

Usage: ``python -m tetris_piclim_tpu_torch <command> [flags]``. The flags
are those of ``tetris_piclim_tpu.cli``, plus ``--device {cuda,cpu}`` on the
commands that run on a device (default cuda; there is no silent CPU
fallback). ``train --smoke`` shrinks the sizes (task L=1/M=8, 64 envs, bank
64, replay 8192, 400 steps, at most 64 demo rows into a 512-row demo
buffer) and keeps every other flag. ``train --config FILE`` reads a
``TrainConfig`` JSON, and every flag the user set to other than its default
overrides the file, as in the JAX CLI; here that covers every flag that maps
to a config field (the JAX CLI's list leaves out ``--lr``, ``--opt-bf16``,
``--actor-fusion`` and the demo flags). Without ``--device-bank`` the bank
is the trainer's default host fill, as in JAX. ``train --profile-dir DIR``
writes a ``torch.profiler`` trace of the training loop into DIR
(``utils/profiling.py::device_trace``), as the JAX CLI writes a
``jax.profiler`` one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


# (flag, TrainConfig field) pairs that ``--config`` lets a changed flag
# override, per config section
_OVERRIDES = {
    "env": [("lines", "L"), ("moves", "M")],
    "dqn": [("n_step", "n_step"), ("per", "prioritized"),
            ("eps_decay", "eps_decay"), ("double", "double_dqn"),
            ("batch", "batch_size"), ("lr", "lr"), ("opt_bf16", "opt_state_bf16")],
    "top": [("num_envs", "num_envs"), ("bank", "bank_capacity"),
            ("replay", "replay_capacity"), ("warmup", "warmup_steps"),
            ("steps", "total_steps"), ("log_every", "log_every"),
            ("updates", "updates_per_step"), ("actor_fusion", "actor_fusion"),
            ("seed", "seed"), ("checkpoint", "checkpoint_dir"),
            ("checkpoint_every", "checkpoint_every"),
            ("demo_every", "demo_every"), ("demo_ratio", "demo_ratio"),
            ("demo_rows", "demo_rows"), ("demo_margin", "demo_margin"),
            ("demo_margin_weight", "demo_margin_weight")],
}


def _merge_config(args, path: str):
    """The JSON config at ``path`` with every flag the user changed from its
    argparse default laid over it (JAX ``cli.py:100-135``)."""
    from .utils.config import TrainConfig

    with open(path) as fh:
        cfg = TrainConfig.from_json(fh.read())
    default = args._parser.get_default
    kw = {sec: {field: getattr(args, flag) for flag, field in pairs
                if getattr(args, flag) != default(flag)}
          for sec, pairs in _OVERRIDES.items()}
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, **kw["env"]),
                              dqn=dataclasses.replace(cfg.dqn, **kw["dqn"]),
                              **kw["top"])
    changed = {**kw["env"], **kw["dqn"], **kw["top"]}
    if changed:
        print(f"--config merged with CLI overrides: {changed}", file=sys.stderr)
    return cfg


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
    if args.config:
        cfg = _merge_config(args, args.config)
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
    in all and per family; ``holdout.build`` is where its rows came from
    (``make_holdout_bank``'s ``provenance``)."""
    from .gen.bank import FAMILY_CARVE, FAMILY_FORWARD, make_holdout_bank

    cfg = trainer.cfg
    holdout = make_holdout_bank(cfg.env.L, cfg.env.M,
                                capacity=args.holdout_bank,
                                train_bank=trainer.bank, device=args.device)
    out = {"holdout": trainer.evaluate(n_episodes=episodes, bank=holdout)}
    out["holdout"]["families"] = holdout.family_counts
    out["holdout"]["build"] = holdout.provenance
    if args.save_holdout:
        from .utils.checkpoint import save_bank

        save_bank(args.save_holdout, holdout)
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
    from .utils.profiling import device_trace

    cfg = _config(args)
    if args.continue_run and not args.resume:
        print("--continue-run goes on from a --resume checkpoint", file=sys.stderr)
        return 2
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
                         device=args.device, backend=args.backend)
    if args.warm_start:
        trainer.warm_start(args.warm_start)
        print(f"warm-started weights from {args.warm_start}", file=sys.stderr)
    if args.resume:
        trainer.restore_checkpoint(args.resume)
        print(f"resumed from {args.resume} at step "
              f"{trainer.state.global_step}", file=sys.stderr)
    logger = MetricsLogger(path=args.log_file)
    with device_trace(args.profile_dir):
        trainer.train(log_fn=lambda msg: print(msg, file=sys.stderr),
                      refresh_bank=args.refresh_bank,
                      device_refresh_every=args.device_refresh,
                      device_forward_fraction=args.device_forward,
                      device_beam_width=args.device_beam,
                      device_height=height,
                      adaptive_share=args.adaptive_share,
                      adapt_every=args.adapt_every,
                      adapt_rule=args.adapt_rule,
                      continue_run=args.continue_run)
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
    # no bank: the trainer's default host fill, the bank of a default-flag
    # training run of the same seed and capacity
    trainer = DQNTrainer(cfg, bank=bank, net=_net(args, args.seed),
                         device=args.device)
    if args.checkpoint:
        trainer.warm_start(args.checkpoint)
    out = {"bank": trainer.evaluate(n_episodes=args.episodes)}
    if args.eval_holdout:
        out.update(_holdout_eval(args, trainer, args.episodes))
    print(json.dumps(out))
    return 0


def cmd_curriculum(args) -> int:
    from .dqn.curriculum_train import CurriculumTrainer
    from .utils.config import EnvConfig, TrainConfig

    levels = [tuple(int(x) for x in pair.split(":"))
              for pair in args.levels.split(",")]
    cfg = TrainConfig(env=EnvConfig(L=levels[0][0], M=levels[0][1]),
                      num_envs=args.num_envs, bank_capacity=args.bank,
                      replay_capacity=args.replay, warmup_steps=args.warmup,
                      updates_per_step=args.updates, seed=args.seed)
    tr = CurriculumTrainer(levels, cfg=cfg, seed=args.seed,
                           net=_net(args, args.seed), device=args.device)
    hist = tr.train(total_steps=args.steps, chunk=args.chunk,
                    threshold=args.threshold,
                    log_fn=lambda m: print(m, file=sys.stderr))
    eval_rows = tr.evaluate_levels(episodes_per_level=args.eval_episodes)
    for row in eval_rows:
        print(f"eval level {row['level']} (L={row['L']}, M={row['M']}): "
              f"win_rate={row['win_rate']:.3f}", file=sys.stderr)
    print(json.dumps({"train": hist[-1], "eval_per_level": eval_rows}))
    return 0


def cmd_generate(args) -> int:
    import numpy as np

    if args.family == "forward":
        from .gen.pipeline import generate_batch

        games = generate_batch(args.lines, args.moves, seed_start=args.seed_start,
                               seed_end=args.seed_end,
                               initial_height_max=args.height_max,
                               max_attempts=args.max_attempts)
        print(json.dumps({"family": "forward", "winnable": len(games),
                          "attempted": args.seed_end - args.seed_start,
                          "seeds": [g.seed for g in games]}))
    else:
        import random

        from .gen.carver import CarvingGenerator

        rng = random.Random(args.seed_start)
        boards = [CarvingGenerator(args.lines, args.moves, rng=rng).generate()[0]
                  for _ in range(args.count)]
        print(json.dumps({"family": "carve", "generated": len(boards),
                          "mean_filled_cells": float(np.mean([b.sum() for b in boards]))}))
    return 0


def cmd_play(args) -> int:
    import random

    from .env_api import Tetris

    t = Tetris(args.lines, args.moves, warm_reset=False, render=args.render,
               debug=True, seed=args.seed)
    if args.policy == "solution":
        for rot, loc in t.solution:
            t.move(rot, loc)
    elif args.policy == "greedy":
        import numpy as np
        import torch

        from .models.qnet import q_ops
        from .utils.checkpoint import restore_params
        from .utils.device import resolve_device

        if not args.checkpoint:
            print("--policy greedy requires --checkpoint", file=sys.stderr)
            return 2
        dev = resolve_device(args.device)
        net = _net(args, args.seed).to(dev)
        net.load_state_dict(restore_params(args.checkpoint, dev)[0])

        def host_obs():
            board, cur, nxt, lines_left, moves_left, _ = t.get_state()
            oh = np.zeros(14, np.float32)
            oh[cur] = 1.0
            oh[7 + nxt] = 1.0
            return np.concatenate([board.astype(np.float32).reshape(-1), oh,
                                   np.array([lines_left, moves_left, 0.0], np.float32)])

        with torch.no_grad():
            while t.state is None:
                q = net(torch.as_tensor(host_obs(), device=dev)[None])
                rot, col = q_ops(q.shape[-1]).greedy(q)
                t.move(int(rot[0]), int(col[0]))
    else:
        rng = random.Random(args.seed)
        while t.state is None:
            t.move(rng.randint(0, 3), rng.randint(0, 9))
    print(json.dumps({"result": {True: "win", False: "loss"}[t.state],
                      "lines_cleared": t.lines_cleared,
                      "moves_used": t.moves_used}))
    t.terminate()
    return 0


def cmd_bench(args) -> int:
    from .bench import run

    res = run(device=args.device, train=not args.no_train)
    keys = ("metric", "value", "unit", "vs_baseline", "train_env_steps_per_s",
            "train_mfu", "train_learner_share")
    keys = tuple(k for k in keys if k in res)
    print(json.dumps({k: res[k] for k in keys}))
    print("# " + " ".join(f"{k}={v}" for k, v in res.items() if k not in keys),
          file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tetris_piclim_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    def env_flags(p) -> None:
        p.add_argument("-L", "--lines", type=int, default=2, help="lines to clear")
        p.add_argument("-M", "--moves", type=int, default=20, help="move budget")

    def model_flags(p) -> None:
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

    def device_flag(p) -> None:
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    def common(p, bank_default: int) -> None:
        env_flags(p)
        p.add_argument("--bank", type=int, default=bank_default)
        p.add_argument("--seed", type=int, default=0)
        model_flags(p)
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
        p.add_argument("--save-holdout", metavar="DIR",
                       help="write the --eval-holdout bank's rows and families "
                            "to DIR/bank.pt (port only)")
        p.add_argument("--checkpoint")
        device_flag(p)

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
    p.add_argument("--continue-run", action="store_true",
                   help="with --resume: go on as one unbroken run would (the "
                        "chunk count and the refresh seeds carry on from the "
                        "checkpoint's step; DQNTrainer.train(continue_run=True))")
    p.add_argument("--warm-start", help="load only the network weights of a "
                                        "checkpoint (same architecture)")
    p.add_argument("--log-file", help="JSONL metrics path")
    p.add_argument("--profile-dir", help="write a torch.profiler trace of the "
                   "training loop here (TensorBoard / Chrome trace JSON)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny sizes (see the module docstring)")
    p.add_argument("--config", help="TrainConfig JSON file; flags set to "
                                    "other than their defaults override it")
    p.add_argument("--refresh-bank", action="store_true",
                   help="run the bank's producer processes (host carves and "
                        "DFS-proven forward games) during training, swapping "
                        "fresh rows into the live bank")
    p.add_argument("--backend", choices=["bitboard", "array"], default="bitboard",
                   help="bitboard = the packed production step; array = the "
                        "readable engine (engine.py)")
    p.set_defaults(fn=cmd_train, _parser=p)

    p = sub.add_parser("curriculum",
                       help="curriculum DQN over (L, M) levels with promotion")
    p.add_argument("--levels", default="1:10,2:15,3:20",
                   help="comma-separated L:M pairs, easiest first")
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--bank", type=int, default=1024, help="rows per level")
    p.add_argument("--replay", type=int, default=131072)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--chunk", type=int, default=1000)
    p.add_argument("--threshold", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-episodes", type=int, default=256,
                   help="final greedy evaluation episodes per level")
    p.add_argument("--updates", type=int, default=1,
                   help="learner updates per env step")
    model_flags(p)
    device_flag(p)
    p.set_defaults(fn=cmd_curriculum)

    p = sub.add_parser("eval", help="greedy-policy win rate")
    common(p, 256)
    p.add_argument("--episodes", type=int, default=1024)
    p.add_argument("--restore-bank", metavar="CKPT",
                   help="evaluate on the live bank rows a training run saved "
                        "with its checkpoint instead of rebuilding the bank")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("generate", help="winnable-config generation")
    env_flags(p)
    p.add_argument("--family", choices=["forward", "carve"], default="forward")
    p.add_argument("--seed-start", type=int, default=0)
    p.add_argument("--seed-end", type=int, default=100)
    p.add_argument("--height-max", type=int, default=4)
    p.add_argument("--max-attempts", type=int, default=1000)
    p.add_argument("--count", type=int, default=100, help="carve family only")
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("play", help="play one episode")
    env_flags(p)
    p.add_argument("--policy", choices=["random", "solution", "greedy"],
                   default="solution")
    p.add_argument("--render", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", help="training checkpoint for --policy greedy")
    model_flags(p)
    device_flag(p)
    p.set_defaults(fn=cmd_play)

    p = sub.add_parser("bench", help="env-step throughput benchmark")
    p.add_argument("--no-train", action="store_true",
                   help="leave out the training recipe's env-steps/s, MFU and "
                        "learner share (bench.py's BENCH_NO_MFU)")
    device_flag(p)
    p.set_defaults(fn=cmd_bench)

    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
