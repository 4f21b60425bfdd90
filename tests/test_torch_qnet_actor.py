"""Port Q-network and fused-actor plain version vs the JAX package.

Weights go across with ``params_from_flax``; Q-values agree within 1e-5
relative (float32 sums in another order), and greedy actions are identical
on inputs whose top-two gap is at least 1e-4, which the test asserts so that
a near-tie cannot pass for a fault. The actor's plain version is held
against the XLA actor loop of tests/test_pallas_actor.py at epsilon 0 with
the same reset rows: every transition field identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.dqn import agent as jagent
from tetris_piclim_tpu.models.qnet import QNetwork as JQNetwork
from tetris_piclim_tpu.models.qnet import q_ops as j_q_ops
from tetris_piclim_tpu.ops import bitboard as jbb
from tetris_piclim_tpu_torch.models.qnet import QNetwork, params_from_flax, q_ops
from tetris_piclim_tpu_torch.ops import actor as tactor
from tetris_piclim_tpu_torch.ops import bitboard as tbb
from torch_port_helpers import adversarial_boards, bank_rows, t

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _nets(joint: bool, seed: int):
    jnet = JQNetwork(joint=joint)
    jparams = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 217)))
    tnet = QNetwork(joint=joint)
    tnet.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jparams)))
    return jnet, jparams, tnet


def _top2_gap(q: np.ndarray) -> np.ndarray:
    s = np.sort(q, axis=-1)
    return s[..., -1] - s[..., -2]


@pytest.mark.parametrize("joint", [False, True])
def test_qnet_matches_flax(joint):
    jnet, jparams, tnet = _nets(joint, seed=3)
    rng = np.random.default_rng(1)
    n, M = 64, 20
    boards = adversarial_boards(rng, n)
    pieces = rng.integers(0, 7, (n, M + 1)).astype(np.int8)
    state = tbb.make_state_batch(t(boards), t(pieces), 2, M)
    obs = tbb.observe(state)
    q_j = np.asarray(jnet.apply(jparams, jnp.asarray(obs.numpy())))
    with torch.no_grad():
        q_t = tnet(obs).numpy()
    np.testing.assert_allclose(q_t, q_j, rtol=1e-5, atol=1e-5 * np.abs(q_j).max())

    branches = [q_j[:, :4], q_j[:, 4:]] if not joint else [q_j]
    for b in branches:
        assert _top2_gap(b).min() >= 1e-4
    jg = j_q_ops(q_j.shape[-1]).greedy(jnp.asarray(q_j))
    tg = q_ops(q_t.shape[-1]).greedy(torch.as_tensor(q_t))
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # gather / max_value / margin_max on identical Q and actions
    rot = rng.integers(0, 4, n)
    col = rng.integers(0, 10, n)
    jo, to = j_q_ops(q_j.shape[-1]), q_ops(q_j.shape[-1])
    qj, qt = jnp.asarray(q_j), torch.tensor(q_j)
    np.testing.assert_allclose(
        to.gather(qt, t(rot), t(col)).numpy(),
        np.asarray(jo.gather(qj, jnp.asarray(rot), jnp.asarray(col))), rtol=1e-6)
    np.testing.assert_allclose(
        to.max_value(qt).numpy(), np.asarray(jo.max_value(qj)), rtol=1e-6)
    np.testing.assert_allclose(
        to.margin_max(qt, t(rot), t(col), 0.8).numpy(),
        np.asarray(jo.margin_max(qj, jnp.asarray(rot), jnp.asarray(col), 0.8)),
        rtol=1e-6)


def test_qnet_init_is_lecun_normal():
    net = QNetwork(generator=torch.Generator().manual_seed(0))
    for layer in net.dense:
        w = layer.weight.detach().numpy()
        std = np.sqrt(1.0 / layer.in_features)
        assert abs(w.std() / std - 1.0) < 0.1
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
        assert not layer.bias.detach().numpy().any()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        QNetwork(dueling=True)


def _jax_actor_loop(jnet, jparams, state, bank_cols, bank_pieces, idxs, n_steps):
    """The XLA actor of tests/test_pallas_actor.py, with scripted reset rows."""
    @jax.jit
    def one(state, idx):
        obs = jbb.observe_batch(state)
        rot, col = jagent.select_actions(
            jnet.apply, jparams, obs, jnp.float32(0.0), jax.random.PRNGKey(0))
        res = jbb.step(state, rot, col)
        p = state.pieces.shape[1]

        def at(s, off):
            return jnp.take_along_axis(
                s.pieces.astype(jnp.int32),
                jnp.clip(s.cursor + off, 0, p - 1)[:, None], axis=1)[:, 0]

        rec = {
            "cols": state.cols, "n_cols": res.state.cols,
            "cur": at(state, 0), "nxt": at(state, 1),
            "lines_left": state.lines_goal - state.lines_cleared,
            "moves_left": state.move_limit - state.moves_used,
            "rot": rot, "col": col, "lines_delta": res.lines_delta,
            "done": res.done, "won": res.won,
            "n_cur": at(res.state, 0), "n_nxt": at(res.state, 1),
            "n_lines_left": res.state.lines_goal - res.state.lines_cleared,
            "n_moves_left": res.state.move_limit - res.state.moves_used,
            "n_status": res.state.status.astype(jnp.int32),
        }
        fresh = res.state._replace(
            cols=bank_cols[idx], pieces=bank_pieces[idx],
            cursor=jnp.zeros_like(state.cursor),
            lines_cleared=jnp.zeros_like(state.cursor),
            moves_used=jnp.zeros_like(state.cursor),
            status=jnp.zeros_like(state.status))
        nxt = jax.tree.map(
            lambda f, s: jnp.where(res.done.reshape((-1,) + (1,) * (f.ndim - 1)), f, s),
            fresh, res.state)
        return nxt, rec

    recs = []
    for k in range(n_steps):
        state, rec = one(state, idxs[k])
        recs.append(rec)
    return state, recs


@pytest.mark.parametrize("joint", [False, True])
def test_actor_reference_matches_xla_actor(joint):
    n, bank, L, M, K = 84, 8, 2, 12, 10
    rng = np.random.default_rng(7)
    boards = adversarial_boards(rng, n)
    boards[:, :8] = False
    pieces = rng.integers(0, 7, (n, M + 1)).astype(np.int8)
    bank_boards, bank_pieces = bank_rows(rng, bank, M + 1)
    idxs = rng.integers(0, bank, (K, n)).astype(np.int32)
    jnet, jparams, tnet = _nets(joint, seed=11)

    js = jbb.make_state_batch(jnp.asarray(boards), jnp.asarray(pieces), L, M)
    jbank = jbb.pack_board(jnp.asarray(bank_boards))
    js_final, recs = _jax_actor_loop(
        jnet, jparams, js, jbank, jnp.asarray(bank_pieces), idxs, K)

    ts = tbb.make_state_batch(t(boards), t(pieces), L, M)
    zeros = torch.zeros((K, n))
    draws = (zeros + 1.0, zeros.int(), zeros.int(), t(idxs))
    ts_final, trans, episodes, wins = tactor.actor_rollout_fused(
        ts, tnet, tbb.pack_board(t(bank_boards)), t(bank_pieces), 0, 0,
        eps_start=0.0, eps_end=0.0, eps_decay=1000.0, n_steps=K, draws=draws)

    for f in ("cols", "pieces", "cursor", "lines_cleared", "moves_used", "status"):
        np.testing.assert_array_equal(
            getattr(ts_final, f).numpy(), np.asarray(getattr(js_final, f)), err_msg=f)
    for k, rec in enumerate(recs):
        for name, want in rec.items():
            np.testing.assert_array_equal(
                getattr(trans, name)[k].numpy(), np.asarray(want),
                err_msg=f"step {k} {name}")
    assert int(episodes) == sum(int(np.asarray(r["done"]).sum()) for r in recs)
    assert int(wins) == sum(int(np.asarray(r["won"]).sum()) for r in recs)
    assert len(np.unique((trans.rot * 10 + trans.col).numpy())) > 1
    assert int(episodes) > 0


def test_actor_reference_explores_with_given_draws():
    """epsilon 1: every action is the scripted random (rot, col)."""
    n, M, K = 32, 8, 6
    rng = np.random.default_rng(2)
    boards = np.zeros((n, 20, 10), bool)
    pieces = rng.integers(0, 7, (n, M + 1)).astype(np.int8)
    bank_boards, bank_pieces = bank_rows(rng, 4, M + 1)
    rr = rng.integers(0, 4, (K, n)).astype(np.int32)
    rc = rng.integers(0, 10, (K, n)).astype(np.int32)
    draws = (torch.zeros((K, n)), t(rr), t(rc), torch.zeros((K, n), dtype=torch.int32))
    state = tbb.make_state_batch(t(boards), t(pieces), 1, M)
    _, trans, _, _ = tactor.actor_reference(
        state, QNetwork(), tbb.pack_board(t(bank_boards)), t(bank_pieces), 0,
        eps_start=1.0, eps_end=1.0, eps_decay=1.0, n_steps=K, draws=draws)
    np.testing.assert_array_equal(trans.rot.numpy(), rr)
    np.testing.assert_array_equal(trans.col.numpy(), rc)


def test_pack_mlp_params_layout():
    net = QNetwork(joint=True)
    w = tactor.pack_mlp_params(net)
    assert [tuple(x.shape) for x in w] == [
        (220, 128), (128,), (128, 128), (128,), (128, 128), (128,),
        (128, 128), (128,), (128, 40), (40,)]
    assert not w[0][217:].any()
    np.testing.assert_array_equal(w[0][:217].numpy(), net.dense[0].weight.detach().t().numpy())
