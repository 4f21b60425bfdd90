"""The port's public names against the JAX package's ``__init__`` files,
their lazy loading, and the helpers that came with them
(``generate_board_and_sequence``, ``to_board``, ``step_batch`` /
``observe_batch``, ``init_qnet``), each against its JAX counterpart."""

import ast
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import adversarial_boards, assert_states_equal, pack_np

from tetris_piclim_tpu import engine as jengine
from tetris_piclim_tpu.gen import forward as jforward
from tetris_piclim_tpu.models import qnet as jqnet
from tetris_piclim_tpu.ops import bitboard as jbb
from tetris_piclim_tpu_torch import engine
from tetris_piclim_tpu_torch.gen import forward as tforward
from tetris_piclim_tpu_torch.models import qnet as tqnet
from tetris_piclim_tpu_torch.ops import bitboard as tbb

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ["", "dqn", "gen", "models", "ops", "utils"]
# JAX names the port does not export, each written down in its __init__
NOT_PORTED = {
    "dqn": {"ReplayState", "replay_init", "replay_add", "replay_sample",
            "replay_sample_ext", "replay_update_priority"},
}


def jax_init_names(sub: str) -> set[str]:
    """The names a JAX package ``__init__`` binds: its imports and
    top-level assignments (read from the source, not by importing)."""
    path = ROOT / "tetris_piclim_tpu" / sub / "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names - {"annotations", "__all__"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_jax_init_names_resolve_in_port(sub):
    want = jax_init_names(sub) - NOT_PORTED.get(sub, set())
    assert want, sub
    pkg = importlib.import_module("tetris_piclim_tpu_torch" + (f".{sub}" if sub else ""))
    for name in sorted(want):
        assert getattr(pkg, name) is not None, name
    assert want <= set(pkg.__all__) | {"__version__"}
    assert want <= set(dir(pkg))
    with pytest.raises(AttributeError):
        getattr(pkg, "no_such_name")
    if sub == "dqn":
        assert pkg.ReplayBuffer.__name__ == "ReplayBuffer"
        assert {"ReplayBuffer", "TrainState", "DQNTrainer"} <= set(pkg.__all__)


def test_parallel_waits_for_multi_gpu():
    assert (ROOT / "tetris_piclim_tpu" / "parallel" / "__init__.py").exists()
    assert not (ROOT / "tetris_piclim_tpu_torch" / "parallel").exists()


_LAZY_PROBE = r"""
import json, sys
import tetris_piclim_tpu_torch as p
from tetris_piclim_tpu_torch import dqn, gen, models, ops, utils
seen = ["torch" in sys.modules]
p.tables, p.__version__, utils.TrainConfig, gen.generate_board_and_sequence
seen.append("torch" in sys.modules)
p.step_batch
seen.append("torch" in sys.modules)
print(json.dumps(seen))
"""


def test_top_level_loads_no_torch_until_touched():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _LAZY_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [False, False, True]


@pytest.mark.parametrize("seed,num_pieces,height,goal",
                         [(0, 20, 4, 2), (7, 20, 4, 0), (123, 30, 7, 10), (99, 8, 2, 1)])
def test_generate_board_and_sequence_matches_jax(seed, num_pieces, height, goal):
    jb, js = jforward.generate_board_and_sequence(seed, num_pieces, height, goal)
    tb, ts = tforward.generate_board_and_sequence(seed, num_pieces, height, goal)
    np.testing.assert_array_equal(tb, jb)
    assert tb.dtype == jb.dtype and ts == js and len(ts) == num_pieces


def test_to_board_and_batch_aliases_match_jax():
    rng = np.random.default_rng(3)
    n, M = 96, 12
    boards = adversarial_boards(rng, n)
    pieces = rng.integers(0, 7, (n, M + 1)).astype(np.int8)
    cols = pack_np(boards)
    js = jbb.make_state_batch(jnp.asarray(cols.astype(np.uint32)), jnp.asarray(pieces), 2, M)
    ts = tbb.make_state_batch(torch.as_tensor(cols), torch.as_tensor(pieces), 2, M)
    np.testing.assert_array_equal(tbb.to_board(ts).numpy(), np.asarray(jbb.to_board(js)))
    np.testing.assert_array_equal(tbb.to_board(ts).numpy(), boards)
    assert tbb.step_batch is tbb.step and tbb.observe_batch is tbb.observe
    assert engine.step_batch is engine.step and engine.observe_batch is engine.observe
    ja = jengine.make_state_batch(jnp.asarray(boards), jnp.asarray(pieces), 2, M)
    ta = engine.make_state_batch(torch.as_tensor(boards), torch.as_tensor(pieces), 2, M)
    for k in range(4):
        rot = rng.integers(0, 4, n).astype(np.int32)
        loc = rng.integers(-2, 12, n).astype(np.int32)
        np.testing.assert_array_equal(tbb.observe_batch(ts).numpy(),
                                      np.asarray(jbb.observe_batch(js)))
        np.testing.assert_array_equal(engine.observe_batch(ta).numpy(),
                                      np.asarray(jengine.observe_batch(ja)))
        js = jbb.step_batch(js, jnp.asarray(rot), jnp.asarray(loc)).state
        ts = tbb.step_batch(ts, torch.as_tensor(rot), torch.as_tensor(loc)).state
        assert_states_equal(ts, js, f"bitboard step {k}")
        ja = jengine.step_batch(ja, jnp.asarray(rot), jnp.asarray(loc)).state
        ta = engine.step_batch(ta, torch.as_tensor(rot), torch.as_tensor(loc)).state
        np.testing.assert_array_equal(ta.board.numpy(), np.asarray(ja.board))
        np.testing.assert_array_equal(ta.status.numpy(), np.asarray(ja.status))


@pytest.mark.parametrize("action_dim", [14, 40])
def test_init_qnet_gives_flax_shapes(action_dim):
    jnet, jparams = jqnet.init_qnet(jax.random.PRNGKey(0), action_dim)
    net = tqnet.init_qnet(torch.Generator().manual_seed(0), action_dim)
    flax_sd = tqnet.params_from_flax(jax.tree.map(np.asarray, jparams))
    sd = net.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in flax_sd.items()}
    obs = np.random.default_rng(0).random((5, 217)).astype(np.float32)
    assert net(torch.as_tensor(obs)).shape == (5, action_dim)
    assert np.asarray(jnet.apply(jparams, obs)).shape == (5, action_dim)
    for layer in net.dense:  # lecun_normal weights, zero biases, as flax
        assert torch.count_nonzero(layer.bias) == 0
        std = float(layer.weight.detach().std())
        assert abs(std * layer.in_features ** 0.5 - 1.0) < 0.1, std
    net.load_state_dict(flax_sd)
    np.testing.assert_allclose(net(torch.as_tensor(obs)).detach().numpy(),
                               np.asarray(jnet.apply(jparams, obs)), atol=1e-5)
    with pytest.raises(ValueError):
        tqnet.init_qnet(action_dim=13)
