"""MFU of the flagship training recipe.

Counterpart of ``benchmarks/bench_mfu.py::measure`` at the same shape:
L=5/M=25, ``ConvQNetwork(dueling=True, joint=True)`` (the torso in bf16
with ``bf16=True``), a 1024-row ``fill_device`` bank, replay 131072,
warmup 1000, ``updates`` learner updates per env step, on the trainer's
per-step path (``actor_fusion=0``). Three things are timed, each the best
of ``REPEATS`` calls after a warm-up call, with the device synchronised
around each call:

  chunk    ``DQNTrainer._chunk_plain(scan)`` on the warmed trainer (act +
           step + auto-reset + replay write + ``updates`` learner updates,
           ``scan`` steps); model FLOPs = scan x (actor_fwd + updates x
           learner_update)
  actor    ``scan`` Q-network forwards at the actor batch (``num_envs``),
           divided by ``scan``
  learner  ``scan x updates`` calls of ``learner_update`` on the warmed
           replay (``learner_s_per_chunk_equiv``, the learner's MFU)

``learner_share_of_chunk`` is read from one clock: the trainer's own
(``dqn/train.py::_Clock``: CUDA events around each step's updates on the
card, the host clock on the CPU) summed over the best chunk call, over that
call's wall time. Its spans lie inside the call, so it cannot exceed 1,
as the learner loop timed apart over the chunk timed apart could (two
best-of-``REPEATS`` times of different loops).

FLOPs come from ``utils/mfu.py::counted_flops`` of one unlooped actor
forward and one ``learner_update`` (its backward included; run on copies
of the networks, optimizer and replay, so the trainer's state does not
move; its sample from a generator seeded ``FLOP_COUNT_SEED``), times the
trip counts. The env step is bitwise integer work, not model FLOPs, and is
left out, as in JAX. MFU is against the card's BF16 peak; off a known card
(the CPU) the MFU fields are None and the times and FLOPs are still
reported. ``device_kind`` always names the device.

``python -m tetris_piclim_tpu_torch.bench_mfu [--bf16] ...`` prints one
JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from .dqn import agent as agent_lib
from .dqn.train import DQNTrainer
from .gen.bank import ConfigBank
from .models.convnet import ConvQNetwork
from .ops import bitboard
from .utils import mfu as mfu_lib
from .utils.config import DQNConfig, EnvConfig, TrainConfig
from .utils.device import resolve_device

REPEATS = 3
# The counted ``learner_update`` draws its sample from a generator of its
# own, seeded apart from every generator of the timed trainer (0 and 1) and
# of its bank (a draw of ``random.Random(0)``), so the count replays none of
# their streams; the count does not depend on the rows drawn.
FLOP_COUNT_SEED = 12_345
L, M = 5, 25


def best_seconds(fn, sync) -> float:
    """Best seconds of ``fn()`` over REPEATS calls after one warm-up, with
    the device synchronised around each call."""
    fn()
    sync()
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def best_chunk(tr: DQNTrainer, scan: int, sync) -> tuple[float, float]:
    """Best seconds of ``tr._chunk_plain(scan)`` over REPEATS calls after
    one warm-up, with the device synchronised around each call, and the
    seconds of learner updates inside that call by the trainer's clock."""
    tr._chunk_plain(scan)
    sync()
    tr._clock.total_ms()  # the warm-up's spans
    best = (float("inf"), 0.0)
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        tr._chunk_plain(scan)
        sync()
        dt = time.perf_counter() - t0
        learn = tr._clock.total_ms() / 1e3
        if dt < best[0]:
            best = (dt, learn)
    return best


def _round(x, nd):
    return None if x is None else round(x, nd)


def flagship_trainer(num_envs: int = 2048, scan: int = 512, updates: int = 4,
                     bf16: bool = False, device="cuda") -> DQNTrainer:
    """The trainer :func:`measure` times, before any chunk has run."""
    dev = resolve_device(device)
    cfg = TrainConfig(
        env=EnvConfig(L=L, M=M), dqn=DQNConfig(), num_envs=num_envs,
        bank_capacity=1024, replay_capacity=131072, warmup_steps=1000,
        total_steps=scan, log_every=scan, updates_per_step=updates, seed=0)
    net = ConvQNetwork(dueling=True, joint=True,
                       dtype=torch.bfloat16 if bf16 else torch.float32,
                       generator=torch.Generator().manual_seed(0))
    bank = ConfigBank(L, M, capacity=1024, seed=0, device=dev).fill_device()
    return DQNTrainer(cfg, bank=bank, net=net, device=dev)


def measure(num_envs: int = 2048, scan: int = 512, updates: int = 4,
            bf16: bool = False, device="cuda") -> dict:
    tr = flagship_trainer(num_envs, scan, updates, bf16, device)
    dev, ts, dqn = tr.device, tr.state, tr.cfg.dqn
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))

    out = {
        "bench": "flagship_mfu", "num_envs": num_envs, "scan": scan,
        "updates": updates, "dtype": "bf16" if bf16 else "f32",
        "backend": dev.type,
        "flop_accounting": (
            "FlopCounterMode of unlooped calls x known trip counts; model "
            "FLOPs of matmuls and convolutions only (env bitwise step "
            "excluded)"),
    }

    # -- chunk: the trainer's own per-step chunk, warmed by the first call ----
    t_chunk, t_learn_in_chunk = best_chunk(tr, scan, sync)
    out["chunk_env_steps_per_s"] = round(num_envs * scan / t_chunk, 1)

    # -- FLOP sources (unlooped calls) ------------------------------------------
    obs = bitboard.observe(ts.env)
    with torch.no_grad():
        f_act = mfu_lib.counted_flops(ts.net, obs)
    net_c, target_c, opt_c, replay_c = copy.deepcopy(
        (ts.net, ts.target_net, ts.opt, ts.replay))
    f_upd = mfu_lib.counted_flops(
        agent_lib.learner_update, net_c, target_c, opt_c, replay_c, dqn,
        step_gap=num_envs, beta=1.0,
        generator=torch.Generator(device=dev).manual_seed(FLOP_COUNT_SEED))
    del net_c, target_c, opt_c, replay_c

    # -- learner: scan x updates updates on the warmed replay ------------------
    def learn_many():
        for _ in range(scan * updates):
            agent_lib.learner_update(ts.net, ts.target_net, ts.opt, ts.replay,
                                     dqn, step_gap=num_envs, beta=1.0,
                                     generator=ts.gen)

    t_learn = best_seconds(learn_many, sync)

    # -- actor: scan forwards at the actor batch, per call ---------------------
    @torch.no_grad()
    def fwd_many():
        for _ in range(scan):
            ts.net(obs)

    t_fwd = best_seconds(fwd_many, sync) / scan

    # -- compose -----------------------------------------------------------------
    kind = mfu_lib.device_kind(dev)
    peak = mfu_lib.peak_flops(dev)

    def mfu_of(flops, seconds):
        m = None if flops is None else mfu_lib.mfu_from_flops(flops, seconds, dev)
        return None if m is None else round(m["mfu"], 6)

    out["actor_forward_us"] = round(t_fwd * 1e6, 1)
    out["actor_timing"] = f"{scan} eager forwards, synchronised once, / {scan}"
    out["actor_gflops_per_call"] = _round(None if f_act is None else f_act / 1e9, 4)
    out["actor_mfu"] = mfu_of(f_act, t_fwd)
    out["learner_s_per_chunk_equiv"] = round(t_learn, 4)
    out["learner_share_of_chunk"] = round(t_learn_in_chunk / t_chunk, 3)
    out["learner_gflops_per_update"] = _round(
        None if f_upd is None else f_upd / 1e9, 4)
    out["learner_mfu"] = mfu_of(None if f_upd is None else scan * updates * f_upd,
                                t_learn)
    chunk_flops = (None if f_act is None or f_upd is None
                   else scan * (f_act + updates * f_upd))
    out["chunk_tflops"] = _round(None if chunk_flops is None else chunk_flops / 1e12, 3)
    out["chunk_mfu"] = mfu_of(chunk_flops, t_chunk)
    out["device_kind"] = kind
    out["peak_tflops_bf16"] = None if peak is None else peak / 1e12
    out["value"] = out["chunk_mfu"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tetris_piclim_tpu_torch.bench_mfu")
    ap.add_argument("--num-envs", type=int, default=2048)
    ap.add_argument("--updates", type=int, default=4)
    ap.add_argument("--scan", type=int, default=512)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.num_envs, a.scan, a.updates, a.bf16, a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
