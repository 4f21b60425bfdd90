"""The port's public names against the JAX package's ``__init__`` files and
against every JAX module that has a counterpart module in the port (each
public module-level name and each public method of its classes), the
parameters of every callable the two share (names and defaults), their
lazy loading, and the helpers that came with them
(``generate_board_and_sequence``, ``to_board``, ``step_batch`` /
``observe_batch``, ``init_qnet``), each against its JAX counterpart."""

import ast
import builtins
import importlib
import inspect
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
SUBPACKAGES = ["", "dqn", "gen", "models", "ops", "utils", "parallel"]
# JAX names the port does not export, each written down in its __init__
NOT_PORTED = {
    "dqn": {"ReplayState", "replay_init", "replay_add", "replay_sample",
            "replay_sample_ext", "replay_update_priority"},
}


# JAX modules whose counterpart in the port is another module
MODULE_COUNTERPARTS = {
    "gen/jax_carver.py": "gen/device_carver.py",    # the device carver in torch
    "gen/jax_forward.py": "gen/device_forward.py",  # the device forward generator
    "ops/pallas_rollout.py": "ops/rollout.py",      # csrc/rollout.cu and its wrapper
    "ops/pallas_actor.py": "ops/actor.py",          # csrc/actor.cu and its wrapper
    "utils/cache.py": "ops/_build.py",              # XLA's compile cache: the nvcc cache
}
# public names of JAX modules that their counterparts do not have, and why
MODULE_NAMES_NOT_PORTED = {
    "dqn/replay.py": {
        # the functional replay API: the port's replay is the class
        # ReplayBuffer, whose methods stand for these
        "ReplayState", "replay_init", "replay_add", "replay_add_fields",
        "replay_sample", "replay_sample_ext", "replay_update_priority"},
    # an optax transformation: the port's optimizer is the class AmsgradBf16
    "dqn/agent.py": {"scale_by_amsgrad_bf16"},
    # XLA's cost model; the port counts FLOPs with FlopCounterMode
    "utils/mfu.py": {"compiled_flops"},
}
JAX_MODULES = sorted(
    str(p.relative_to(ROOT / "tetris_piclim_tpu"))
    for p in (ROOT / "tetris_piclim_tpu").rglob("*.py")
    if p.name not in ("__init__.py", "__main__.py"))


def jax_module_names(rel: str) -> dict[str, list[str]]:
    """The public module-level names a JAX module defines (functions,
    classes, constants), each class with its public methods (read from the
    source, not by importing)."""
    tree = ast.parse((ROOT / "tetris_piclim_tpu" / rel).read_text())
    names: dict[str, list[str]] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = []
        elif isinstance(node, ast.ClassDef):
            names[node.name] = [
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not n.name.startswith("_")]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                names.update({e.id: [] for e in elts if isinstance(e, ast.Name)})
    return {k: v for k, v in names.items() if not k.startswith("_")}


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_jax_module_names_resolve_in_counterpart(rel):
    """Every public name of a JAX module, and every public method of its
    classes, resolves in the port's module of the same path; the modules
    the port replaced by another have that module."""
    if rel in MODULE_COUNTERPARTS:
        assert not (ROOT / "tetris_piclim_tpu_torch" / rel).exists(), rel
        assert (ROOT / "tetris_piclim_tpu_torch" / MODULE_COUNTERPARTS[rel]).exists()
        return
    assert (ROOT / "tetris_piclim_tpu_torch" / rel).exists(), rel
    mod = importlib.import_module(
        "tetris_piclim_tpu_torch." + rel[:-3].replace("/", "."))
    skip = MODULE_NAMES_NOT_PORTED.get(rel, set())
    names = jax_module_names(rel)
    assert skip <= set(names), skip - set(names)
    missing = [n for n in names if n not in skip and not hasattr(mod, n)]
    missing += [f"{n}.{m}" for n, methods in names.items() if n not in skip
                and hasattr(mod, n) for m in methods if not hasattr(getattr(mod, n), m)]
    assert not missing, f"{rel}: {missing}"


# JAX parameters that no counterpart takes, and why
PARAMS_NOT_PORTED_ANYWHERE = {
    # a JAX PRNG key: the port draws from a torch.Generator or takes the
    # draws themselves (``draws=``)
    "key",
    # flax parameter trees and their apply function: the port's nets are
    # nn.Modules that carry their weights
    "params", "apply_fn", "target_params",
    # optax's transformation and its state: the port's optimizer is an
    # object (AmsgradW / AmsgradBf16) that holds its moments
    "optimizer", "opt_state",
    # the functional demo replay's pytree: the port passes the demo
    # ReplayBuffer (``demo=``)
    "demo_rpl",
}
# per JAX module and callable, parameters its counterpart does not take,
# and why
PARAMS_NOT_PORTED = {
    # Pallas tiling and interpret mode: the CUDA kernels pick their own
    # launch shape and have no interpret mode; the actor reads its head's
    # width from the net
    "ops/pallas_actor.py": {"actor_rollout_fused": {"tile", "interpret", "head_dim"}},
    "ops/pallas_rollout.py": {"rollout_fused": {"tile", "interpret"}},
    # JAX mesh axes and pytrees: the port's mesh is torch.distributed ranks,
    # one batch axis, and its states are modules and tensors
    "parallel/mesh.py": {"replicate": {"tree"}, "batch_sharding": {"axis"},
                         "shard_train_state": {"axis"}},
    # orbax restores into a template pytree; the port loads into the
    # TrainState it is given (``state``)
    "utils/checkpoint.py": {"restore_train_state": {"template"}},
    # an XLA compiled executable: the port counts the FLOPs of a call
    # (``fn, *args``)
    "utils/mfu.py": {"mfu": {"compiled"}},
    # a multiprocessing queue shared by all producers: the port gives each
    # producer a pipe of its own
    "gen/_producers.py": {"carve_producer": {"queue"}, "forward_producer": {"queue"}},
}
# defaults the port does not keep, and why: its entry points run on the card
# (``device='cuda'``) unless the caller asks for the CPU, where JAX's None
# means its default backend
DEFAULTS_NOT_KEPT = {
    "gen/bank.py": {"ConfigBank.__init__": {"device"}, "make_holdout_bank": {"device"}},
    "utils/checkpoint.py": {"restore_bank": {"device"}},
}


def jax_module_signatures(rel: str) -> dict[str, list[tuple[str, object]]]:
    """The parameters of every public function of a JAX module and of every
    public method (``__init__`` included) of its public classes, each as
    (name, default source or None), read from the source; properties,
    ``self``/``cls`` and ``*args``/``**kwargs`` are left out."""
    tree = ast.parse((ROOT / "tetris_piclim_tpu" / rel).read_text())

    def params(fn):
        a = fn.args
        pos = a.posonlyargs + a.args
        defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
        out = list(zip(pos, defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))
        return [(p.arg, None if d is None else ast.unparse(d))
                for p, d in out if p.arg not in ("self", "cls")]

    def is_property(fn):
        return any(isinstance(d, ast.Name) and d.id == "property"
                   or isinstance(d, ast.Attribute) and d.attr in ("setter", "getter")
                   for d in fn.decorator_list)

    sigs = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            sigs[node.name] = params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for fn in node.body:
                if (isinstance(fn, ast.FunctionDef) and not is_property(fn)
                        and (fn.name == "__init__" or not fn.name.startswith("_"))):
                    sigs[f"{node.name}.{fn.name}"] = params(fn)
    return sigs


def jax_module_literals(rel: str) -> dict:
    """The module-level constants of a JAX module that are plain literals."""
    out = {}
    for node in ast.parse((ROOT / "tetris_piclim_tpu" / rel).read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def _default_value(src: str, jax_literals: dict, namespace: dict):
    """A JAX default from its source: a literal, a literal constant of the
    JAX module, else the expression read in the port module's namespace
    (its own copies of the constants it imports, such as BOARD_H)."""
    try:
        return ast.literal_eval(src)
    except ValueError:
        if src in jax_literals:
            return jax_literals[src]
        return eval(src, {**vars(builtins), **namespace})  # noqa: S307


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_jax_parameters_resolve_in_counterpart(rel):
    """Every parameter of every public callable that a JAX module and its
    counterpart share is a parameter of the port's callable, with JAX's
    default where the port keeps the parameter; the only exceptions are
    the ones listed above, each with its reason, and each is still needed."""
    port_rel = MODULE_COUNTERPARTS.get(rel, rel)
    mod = importlib.import_module(
        "tetris_piclim_tpu_torch." + port_rel[:-3].replace("/", "."))
    not_ported = PARAMS_NOT_PORTED.get(rel, {})
    not_kept = DEFAULTS_NOT_KEPT.get(rel, {})
    literals = jax_module_literals(rel)
    bad, used = [], set()
    for name, params in jax_module_signatures(rel).items():
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is None:
            continue  # not shared: test_jax_module_names_resolve_in_counterpart
        port = inspect.signature(obj).parameters
        for p, default in params:
            if p not in port:
                if p in not_ported.get(name, ()):
                    used.add((name, p))
                elif p not in PARAMS_NOT_PORTED_ANYWHERE:
                    bad.append(f"{name}: no parameter {p!r}")
                continue
            if default is None:
                continue
            if p in not_kept.get(name, ()):
                used.add((name, p))
                assert port[p].default == "cuda", (name, p)
                continue
            want = _default_value(default, literals, vars(mod))
            got = port[p].default
            if got is inspect.Parameter.empty:
                bad.append(f"{name}: {p!r} has no default, JAX's is {default}")
            elif got != want or type(got) is not type(want):
                bad.append(f"{name}: {p}={got!r}, JAX's is {default}")
    assert not bad, f"{rel}: {bad}"
    listed = {(n, p) for d in (not_ported, not_kept) for n, ps in d.items() for p in ps}
    assert listed <= used, f"{rel}: listed but not needed: {listed - used}"


def test_jax_keywords_reach_the_port():
    """The keywords that differed once: ``engine.step(location=)`` and
    ``bitboard.from_env_state(env_state=)`` give what JAX's give."""
    rng = np.random.default_rng(4)
    n, M = 32, 8
    boards = adversarial_boards(rng, n)
    pieces = rng.integers(0, 7, (n, M + 1)).astype(np.int8)
    rot = rng.integers(0, 4, n).astype(np.int32)
    loc = rng.integers(-2, 12, n).astype(np.int32)
    ja = jengine.make_state_batch(jnp.asarray(boards), jnp.asarray(pieces), 2, M)
    ta = engine.make_state_batch(torch.as_tensor(boards), torch.as_tensor(pieces), 2, M)
    jr = jengine.step_batch(ja, rotations=jnp.asarray(rot), location=jnp.asarray(loc))
    tr = engine.step(ta, rotations=torch.as_tensor(rot), location=torch.as_tensor(loc))
    np.testing.assert_array_equal(tr.state.board.numpy(), np.asarray(jr.state.board))
    np.testing.assert_array_equal(tr.lines_delta.numpy(), np.asarray(jr.lines_delta))
    assert_states_equal(tbb.from_env_state(env_state=tr.state),
                        jbb.from_env_state(env_state=jr.state), "from_env_state")


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
    """The port's ``parallel`` (A18) gives JAX's names plus
    ``dryrun_multigpu``, in place of ``__graft_entry__.dryrun_multichip``."""
    from tetris_piclim_tpu_torch import parallel

    assert set(parallel.__all__) == jax_init_names("parallel") | {
        "init_distributed", "sync_hosts", "dryrun_multigpu"}
    assert parallel.dryrun_multigpu.__module__.endswith("parallel.dryrun")


_LAZY_PROBE = r"""
import json, sys
import tetris_piclim_tpu_torch as p
from tetris_piclim_tpu_torch import dqn, gen, models, ops, parallel, utils
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


def test_piece_ids_and_mask_rtopo_match_jax():
    from tetris_piclim_tpu import tables as jt
    from tetris_piclim_tpu_torch import tables as tt

    names = ["PIECE_I", "PIECE_L", "PIECE_J", "PIECE_T", "PIECE_S", "PIECE_Z", "PIECE_O"]
    assert [getattr(tt, n) for n in names] == [getattr(jt, n) for n in names]
    assert [tt.PIECE_IDS[n[-1]] for n in names] == [getattr(tt, n) for n in names]
    rng = np.random.default_rng(5)
    masks = [m.astype(bool) for shapes in tt.GEN_SHAPES.values() for m in shapes]
    masks += [rng.random((h, w)) < 0.5 for h, w in rng.integers(1, 5, (64, 2))]
    masks = [m | (np.arange(m.shape[0])[:, None] == 0) for m in masks]  # a cell per column
    for m in masks:
        got = tt.mask_rtopo(m)
        np.testing.assert_array_equal(got, jt.mask_rtopo(m))
        assert got.dtype == np.int32
    for p in range(tt.NUM_PIECES):
        for r in range(tt.MAX_ROT):
            m, topo = tt.get_tetromino(p, r)
            assert tuple(tt.mask_rtopo(m)) == topo


@pytest.mark.parametrize("seed,goal", [(3, 1), (11, 2), (42, 1)])
def test_solver_replay_matches_jax(seed, goal):
    from tetris_piclim_tpu.gen.forward import ForwardGenerator as JGen
    from tetris_piclim_tpu.gen.solver import GreedyDFSSolver as JSolver
    from tetris_piclim_tpu_torch.gen.solver import GreedyDFSSolver

    game = JGen(seed=seed, goal=goal, num_pieces=10, initial_height_max=4)
    js = JSolver(game.board, game.sequence, goal, max_attempts=1000)
    ok, stack, _ = js.solve()
    if not ok:  # a prefix of any placement sequence replays too
        stack = [(name, 0, 0) for name in game.sequence[:3]]
    ts = GreedyDFSSolver(game.board, game.sequence, goal, max_attempts=1000)
    lines = ts.replay(stack)
    assert lines == js.replay(stack)
    np.testing.assert_array_equal(ts.board, js.board)
    assert lines == ts.visualize_moves(stack, print_fn=lambda *_: None)
    assert ts.replay(stack) == lines  # replay starts from the initial board
    if ok:
        assert lines >= goal
