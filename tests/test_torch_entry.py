"""``tetris_piclim_tpu_torch.entry()`` against ``__graft_entry__.entry()``:
the flagship net (conv torso, dueling, joint head) on 256 envs, epsilon-
greedy at 0.05, one lockstep step. JAX's weights are carried across with
``params_from_flax`` and JAX's three draws (explore uniforms, random
rotation and column, split from its key as ``agent.select_actions`` splits
them) are passed to the port. Q within 1e-4; actions, env state, lines and
dones equal, over three chained steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_states_equal

import __graft_entry__
from tetris_piclim_tpu.dqn import agent as jagent
from tetris_piclim_tpu.models.convnet import ConvQNetwork as JConvQNetwork
from tetris_piclim_tpu.models.qnet import NUM_COL, NUM_ROT
from tetris_piclim_tpu.ops import bitboard as jbb
from tetris_piclim_tpu_torch import entry as port_entry
from tetris_piclim_tpu_torch.dqn import agent
from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork, params_from_flax
from tetris_piclim_tpu_torch.ops import bitboard as tbb

torch.set_num_threads(1)


def jax_draws(key, n: int):
    """The draws ``agent.select_actions`` makes from ``key``."""
    k_expl, k_rot, k_col = jax.random.split(key, 3)
    return (jax.random.uniform(k_expl, (n,)),
            jax.random.randint(k_rot, (n,), 0, NUM_ROT),
            jax.random.randint(k_col, (n,), 0, NUM_COL))


@pytest.fixture(scope="module")
def jax_entry(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    try:
        yield __graft_entry__.entry()
    finally:
        mp.undo()


def test_entry_matches_graft_entry(jax_entry):
    jstep, (params, jstates, key) = jax_entry
    step, (net, states, *_) = port_entry(device="cpu")
    assert isinstance(net, ConvQNetwork) and net.dueling and net.joint
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), net))
    assert_states_equal(states, jstates, "initial states")
    jstep = jax.jit(jstep)
    japply = JConvQNetwork(dueling=True, joint=True).apply  # the closure's net
    explored = 0
    for k in range(3):
        key, sub = jax.random.split(key)
        u, r_rot, r_col = jax_draws(sub, 256)
        obs = jbb.observe_batch(jstates)
        q_j = np.asarray(japply(params, obs))
        q_t = net(tbb.observe_batch(states)).detach().numpy()
        np.testing.assert_allclose(q_t, q_j, atol=1e-4, err_msg=f"step {k} Q")
        j_rot, j_col = jagent.select_actions(japply, params, obs, jnp.float32(0.05), sub)
        draws = [torch.as_tensor(np.array(x)) for x in (u, r_rot, r_col)]
        t_rot, t_col = agent.select_actions(net, tbb.observe_batch(states), 0.05,
                                            explore_u=draws[0], r_rot=draws[1],
                                            r_col=draws[2])
        np.testing.assert_array_equal(t_rot.numpy(), np.asarray(j_rot))
        np.testing.assert_array_equal(t_col.numpy(), np.asarray(j_col))
        explored += int((draws[0] < 0.05).sum())
        jstates, j_lines, j_done = jstep(params, jstates, sub)
        states, lines, done = step(net, states, *draws)
        assert_states_equal(states, jstates, f"step {k}")
        assert int(lines) == int(j_lines) and int(done) == int(j_done)
    assert explored > 0


def test_entry_example_args_run_on_their_device():
    step, args = port_entry(device="cpu")
    net, states, explore, rand_rot, rand_col = args
    assert states.cols.shape == (256, 10) and states.pieces.shape == (256, 21)
    assert explore.shape == rand_rot.shape == rand_col.shape == (256,)
    assert int(rand_rot.max()) < NUM_ROT and int(rand_col.max()) < NUM_COL
    new, lines, done = step(*args)
    assert int(new.moves_used.min()) == 1 and int(lines) == int(done) == 0
    again = port_entry(device="cpu")[1]
    assert all(torch.equal(a, b) for a, b in zip(args[2:], again[2:]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_entry()
