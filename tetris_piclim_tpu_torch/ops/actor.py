"""Fused DQN actor: K steps of observe -> Q-MLP -> epsilon-greedy -> env
step -> bank auto-reset, with packed transition records.

Counterpart of ``tetris_piclim_tpu/ops/pallas_actor.py``.
:func:`actor_rollout_fused` launches ``csrc/actor.cu`` for a state on the
GPU and runs :func:`actor_reference`, the plain PyTorch version, for a
state on the CPU. The policy is frozen for the K steps of one call.

Per step (the semantics of ``agent.select_actions`` + ``bitboard.step``):
greedy is a first-occurrence argmax per branch (head 14: lanes 0-3 and
4-13) or over the joint head (40); epsilon is
``eps_end + (eps_start - eps_end) * exp(-(global_step + k) / eps_decay)``;
an env explores when its uniform draw is below epsilon and then plays a
uniform random (rot, col); finished envs reset to a uniform bank row.

Draws are scripted ``draws=(explore_u, rand_rot, rand_col, reset_idx)``,
each [K, N] (the verification path), or random: Philox in the kernel, a
``torch.Generator`` in the plain version. ``rollout.philox_draws`` gives the
kernel's Philox stream as scripted draws, which is how its random mode is
held against the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..engine import OBS_DIM
from ..models.qnet import QNetwork, q_ops
from . import _build
from . import bitboard as bb
from .rollout import check_state, new_state_like, scripted

HID = 128
N_HIDDEN = 4
T_INT_W = 16      # packed int transition lanes (14 used)


class ActorTransitions(NamedTuple):
    """K steps of transitions, leading axes [K, N]."""
    cols: torch.Tensor          # int32[K, N, 10] s (before the action)
    n_cols: torch.Tensor        # int32[K, N, 10] s' (after it, before reset)
    cur: torch.Tensor           # int32[K, N]
    nxt: torch.Tensor
    lines_left: torch.Tensor
    moves_left: torch.Tensor
    rot: torch.Tensor
    col: torch.Tensor
    lines_delta: torch.Tensor
    done: torch.Tensor          # bool[K, N]
    won: torch.Tensor           # bool[K, N]
    n_cur: torch.Tensor
    n_nxt: torch.Tensor
    n_lines_left: torch.Tensor
    n_moves_left: torch.Tensor
    n_status: torch.Tensor


def epsilon(step: int, eps_start: float, eps_end: float,
            eps_decay: float) -> torch.Tensor:
    """f32 0-d CPU tensor ``eps_end + (eps_start - eps_end) *
    exp(-step / eps_decay)``, in float32 as the kernel computes it."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return f(eps_end) + (f(eps_start) - f(eps_end)) * torch.exp(
        -f(float(step)) / f(eps_decay))


def mlp_params(net: QNetwork) -> list[torch.Tensor]:
    """The kernel's weights, ``[w1, b1, ..., w5, b5]``: the network's own
    float32 parameters in ``nn.Linear``'s [out, in] layout, read in place.
    Nothing is copied, transposed or padded (the kernel handles layer 1's
    217-float rows itself), so a call costs no device work."""
    layers = list(getattr(net, "dense", []))
    widths = [(lay.in_features, lay.out_features) for lay in layers]
    if getattr(net, "dueling", True) \
            or widths[:-1] != [(OBS_DIM, HID)] + [(HID, HID)] * (N_HIDDEN - 1) \
            or widths[-1][0] != HID:
        raise ValueError("the fused actor runs the plain (non-dueling) "
                         "217 -> 4x128 -> head MLP")
    out = []
    for lay in layers:
        for p in (lay.weight, lay.bias):
            p = p.detach()
            if p.dtype != torch.float32 or not p.is_contiguous() \
                    or p.data_ptr() % 16:
                raise ValueError("the fused actor reads contiguous, 16-byte "
                                 "aligned float32 parameters in place")
            out.append(p)
    return out


@torch.no_grad()
def actor_reference(
    state: bb.PackedState,
    net: QNetwork,
    bank_cols: torch.Tensor,
    bank_pieces: torch.Tensor,
    global_step: int,
    *,
    eps_start: float,
    eps_end: float,
    eps_decay: float,
    n_steps: int,
    draws=None,
    generator: torch.Generator | None = None,
    return_q: bool = False,
):
    """K actor steps in plain PyTorch. Returns ``(state, transitions,
    episodes, wins)`` and, with ``return_q``, the Q-values [K, N, head]."""
    n, dev = state.cols.shape[0], state.cols.device
    bank = bank_cols.shape[0]
    ops = q_ops(net.head_dim)
    recs, qs = [], []
    episodes = torch.zeros((), dtype=torch.int64, device=dev)
    wins = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(n_steps):
        if draws is not None:
            u, rr, rc, idx = (d[k] for d in draws)
        else:
            u = torch.rand((n,), generator=generator, device=dev)
            rr, rc, idx = (torch.randint(0, hi, (n,), generator=generator,
                                         device=dev) for hi in (4, 10, bank))
        q = net(bb.observe(state))
        rot_g, col_g = ops.greedy(q)
        explore = u < epsilon(global_step + k, eps_start, eps_end, eps_decay)
        rot = torch.where(explore, rr.long(), rot_g).to(torch.int32)
        col = torch.where(explore, rc.long(), col_g).to(torch.int32)
        nxt_state, res = bb.step_autoreset_batch(
            state, rot, col, bank_cols, bank_pieces, idx)
        after = res.state
        recs.append((state.cols, after.cols, *bb.packed_fields(state)[1:5],
                     rot, col, res.lines_delta, res.done, res.won,
                     *bb.packed_fields(after)[1:5], after.status.to(torch.int32)))
        qs.append(q)
        episodes += res.done.sum()
        wins += res.won.sum()
        state = nxt_state
    trans = ActorTransitions(*[torch.stack(f) for f in zip(*recs)])
    out = (state, trans, episodes, wins)
    return out + (torch.stack(qs),) if return_q else out


def actor_rollout_fused(
    state: bb.PackedState,
    net: QNetwork,
    bank_cols: torch.Tensor,     # int32[B, 10]
    bank_pieces: torch.Tensor,   # int8[B, P]
    global_step: int,
    seed: int,
    *,
    eps_start: float,
    eps_end: float,
    eps_decay: float,
    n_steps: int,
    draws=None,
    return_q: bool = False,
):
    """K fused actor steps. Returns ``(state, transitions, episodes, wins)``
    (+ Q-values [K, N, head] with ``return_q``, a verification output).

    On a CUDA state this launches the kernel (and raises if it cannot); on a
    CPU state it runs :func:`actor_reference`, drawing from a generator
    seeded by ``seed`` when ``draws`` is None."""
    if not state.cols.is_cuda:
        gen = torch.Generator(device=state.cols.device).manual_seed(seed)
        return actor_reference(
            state, net, bank_cols, bank_pieces, global_step,
            eps_start=eps_start, eps_end=eps_end, eps_decay=eps_decay,
            n_steps=n_steps, draws=draws, generator=gen, return_q=return_q)
    launch, collect = prepare_actor_launch(
        state, net, bank_cols, bank_pieces, global_step, seed,
        eps_start=eps_start, eps_end=eps_end, eps_decay=eps_decay,
        n_steps=n_steps, draws=draws, return_q=return_q)
    launch()
    return collect()


def prepare_actor_launch(state, net, bank_cols, bank_pieces, global_step, seed,
                         *, eps_start, eps_end, eps_decay, n_steps, draws=None,
                         return_q=False):
    """Validate the inputs of :func:`actor_rollout_fused` for a CUDA state
    and allocate its outputs. Returns ``(launch, collect)``: ``launch()``
    enqueues the kernel on the current stream (and counts the launch),
    ``collect()`` returns what :func:`actor_rollout_fused` returns from the
    buffers of the last launch. Calling ``launch`` again reruns the kernel
    on the same buffers (the episode counts accumulate): that is how the
    kernel is timed without the wrapper's host work."""
    check_state(state, bank_cols, bank_pieces)
    n, p = state.pieces.shape
    bank = bank_cols.shape[0]
    dev = state.cols.device
    weights = mlp_params(net)
    if any(not w.is_cuda for w in weights):
        raise ValueError("the Q-network must live on the GPU with the state")
    explore_u = rand_rot = rand_col = reset_idx = None
    if draws is not None:
        explore_u = draws[0].to(torch.float32).contiguous()
        if tuple(explore_u.shape) != (n_steps, n):
            raise ValueError("explore_u must be float[K, N]")
        rand_rot, rand_col, reset_idx = scripted(
            draws[1:], n_steps, n, (4, 10, bank))
    head = net.head_dim
    out = new_state_like(state)
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    t_cols = torch.empty((n_steps, n, 10), dtype=torch.int32, device=dev)
    t_ncols = torch.empty_like(t_cols)
    t_int = torch.empty((n_steps, n, T_INT_W), dtype=torch.int32, device=dev)
    q_out = (torch.empty((n_steps, n, head), dtype=torch.float32, device=dev)
             if return_q else None)
    ptr = _build.ptr
    lib = _build.load("actor")
    args = (
        ptr(state.cols), ptr(state.pieces), ptr(state.cursor),
        ptr(state.lines_cleared), ptr(state.moves_used), ptr(state.status),
        ptr(state.lines_goal), ptr(state.move_limit),
        ptr(bank_cols), ptr(bank_pieces), bank, n, p, n_steps, head,
        *[ptr(w) for w in weights],
        int(global_step), float(eps_start), float(eps_end), float(eps_decay),
        seed & 0xFFFFFFFF,
        ptr(explore_u), ptr(rand_rot), ptr(rand_col), ptr(reset_idx),
        ptr(bb.kernel_tables(dev)),
        ptr(out.cols), ptr(out.pieces), ptr(out.cursor),
        ptr(out.lines_cleared), ptr(out.moves_used), ptr(out.status),
        ptr(stats), ptr(t_cols), ptr(t_ncols), ptr(t_int), ptr(q_out),
    )

    def launch() -> None:
        rc = lib.actor_launch(*args, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "actor")
        _build.LAUNCHES["actor"] += 1

    # `args` holds raw addresses: the launcher keeps their tensors alive
    launch.keep_alive = (state, weights, bank_cols, bank_pieces, explore_u,
                         rand_rot, rand_col, reset_idx)

    def collect():
        lane = lambda i: t_int[..., i]  # noqa: E731
        trans = ActorTransitions(
            cols=t_cols, n_cols=t_ncols,
            cur=lane(0), nxt=lane(1), lines_left=lane(2), moves_left=lane(3),
            rot=lane(4), col=lane(5), lines_delta=lane(6),
            done=lane(7).bool(), won=lane(8).bool(),
            n_cur=lane(9), n_nxt=lane(10), n_lines_left=lane(11),
            n_moves_left=lane(12), n_status=lane(13),
        )
        res = (out, trans, stats[0], stats[1])
        return res + (q_out,) if return_q else res

    return launch, collect
