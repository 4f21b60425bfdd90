"""The port's generators against the JAX package's on identical draws, and
the parts of their API the port shares with JAX: ``max_iters`` and
``draws=`` on the device carver (``gen/device_carver.py`` against
``gen/jax_carver.py``), ``max_iters`` on the prefill, and the host
pipeline's process pool. Every comparison is exact: boards, pieces,
solutions and move counts word for word, games field for field."""

import functools
import hashlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.gen import jax_carver as jc
from tetris_piclim_tpu.gen import jax_forward as jf
from tetris_piclim_tpu.gen.pipeline import generate_batch as jax_generate_batch
from tetris_piclim_tpu_torch.gen import device_carver as tc
from tetris_piclim_tpu_torch.gen import device_forward as tf

ROOT = Path(__file__).resolve().parents[1]

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

FIELDS = ("boards", "pieces", "rotations", "locations", "n_moves")


@functools.partial(jax.jit, static_argnames=("n", "iters", "P"))
def _jax_carver_draws(key, n, iters, P):
    """JAX's carver draws, rebuilt key split by key split: each iteration's
    ``split(key, 4)`` then randint, randint, uniform
    (gen/jax_carver.py:85-93), and for every iteration count T the pad that
    the final ``split(key)`` draws after T iterations (:192-196)."""
    def body(k, _):
        k, k_p, k_r, k_l = jax.random.split(k, 4)
        return k, (jax.random.randint(k_p, (n,), 0, 7),
                   jax.random.randint(k_r, (n,), 0, 4),
                   jax.random.uniform(k_l, (n,)), k)

    _, (piece, rot, u, keys) = jax.lax.scan(body, key, None, length=iters)
    pads = jax.vmap(lambda k: jax.random.randint(
        jax.random.split(k)[1], (n, P), 0, 7, dtype=jnp.int8))(keys)
    return piece, rot, u, pads  # pads[T - 1]: the pad after T iterations


_jax_carve = jax.jit(jc.generate_batch_device,
                     static_argnames=("n", "L", "M", "max_iters"))


def _loop_length(want, pads) -> int:
    """The iteration count T at which JAX's loop stopped: the one whose pad
    gives every padded slot of JAX's pieces: those past ``n_moves`` of a
    done row, and the last of an undone row, whose carve count (< M) the
    output does not give."""
    n_mv = np.asarray(want.n_moves)
    pieces = np.asarray(want.pieces)
    slot = np.arange(pieces.shape[1])[None, :]
    padded = np.where(n_mv[:, None] > 0, slot >= n_mv[:, None], slot == slot.max())
    hits = [T for T in range(1, len(pads) + 1)
            if (pads[T - 1][padded] == pieces[padded]).all()]
    assert len(hits) == 1, hits
    return hits[0]


# cut budgets chosen so that some rows end undone and some finish
@pytest.mark.parametrize("L,M,cut", [(2, 20, 20), (5, 25, 40), (2, 20, None),
                                     (5, 25, None)])
def test_carver_matches_jax_on_jax_draws(L, M, cut):
    n = 64
    key = jax.random.PRNGKey(L)
    budget = 24 * M + 512 if cut is None else cut
    want = _jax_carve(key, n=n, L=L, M=M, max_iters=cut)
    piece, rot, u, pads = (np.array(a) for a in
                           _jax_carver_draws(key, n=n, iters=budget, P=M + 1))
    T = _loop_length(want, pads)
    n_mv = np.asarray(want.n_moves)
    if cut is None:
        assert T < budget and (n_mv > 0).all()
    else:  # some rows undone: JAX ran the whole budget
        assert T == cut and 0 < (n_mv > 0).sum() < n

    def check(got):
        for name in FIELDS:
            np.testing.assert_array_equal(
                getattr(got, name).numpy(),
                np.asarray(getattr(want, name)).astype(getattr(got, name).numpy().dtype),
                err_msg=name)

    draws = tuple(torch.as_tensor(a) for a in (piece, rot, u))
    check(tc.generate_batch_device(
        n, L, M, max_iters=cut,
        draws=tuple(d[:T] for d in draws) + (torch.as_tensor(pads[T - 1]),)))
    # draws past the loop's end change nothing: done rows are frozen, and a
    # budget cuts the draws
    more = tuple(d[:T + 40] for d in draws) if cut is None else draws
    check(tc.generate_batch_device(
        n, L, M, max_iters=cut, draws=more + (torch.as_tensor(pads[T - 1]),)))


def _digest(fields) -> str:
    h = hashlib.sha256()
    for f in fields:
        a = f.numpy()
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# SHA-256 of the generator path's outputs, recorded before the carver took
# ``draws=`` and ``max_iters``: the banks and the runs built on the old
# stream stay reproducible
CARVE_DIGESTS = {
    (64, 2, 20, 0): "44f3d58ea97bf224892dc2402f57286d45c7813d70295904fb2c9b2667c560e3",
    (64, 5, 25, 1): "721ef7bb1aaa75d629810a9b6d4eddc4087dbf5c45faf41a4e33246dadefc6d5",
    (48, 1, 8, 3): "812a95b410029f397928f31fde617ac9337798b0a065de21590654b0e640ac10",
    (32, 10, 30, 2): "de63cfcaedc58c14b8ade7d64279b458303a714ea1ab7ac4f2aa2038794ca203",
}
PREFILL_DIGESTS = {
    (64, 4, 0): "2ee64e0a68de7c579b590ce62a4a3242df62a32c22a4c78d3e22768cf92e6cb1",
    (64, 7, 5): "6fdbf28e56b0e2d3c7d9f54d92d8ce64007972a4f68e955dc6d8dd9003ca054e",
}
FORWARD_DIGEST = ((32, 2, 12, 4, 8, 0),
                  "b06f356ae76feece94a9668d0c7fb89b00dbc72a3ff1a87486477d804fd04fed")


@pytest.mark.parametrize("n,L,M,seed", sorted(CARVE_DIGESTS))
def test_carver_generator_stream_unchanged(n, L, M, seed):
    b = tc.generate_batch_device(n, L, M, generator=torch.Generator().manual_seed(seed),
                                 device="cpu")
    assert _digest(b) == CARVE_DIGESTS[n, L, M, seed]
    assert (b.n_moves > 0).all()


def test_prefill_and_forward_generator_stream_unchanged():
    for (n, cap, seed), want in PREFILL_DIGESTS.items():
        cols = tf.prefill_boards_device(n, cap, generator=torch.Generator().manual_seed(seed),
                                        device="cpu")
        assert _digest([cols]) == want
    (n, L, M, cap, beam, seed), want = FORWARD_DIGEST
    fb = tf.generate_batch_device(n, L, M, cap, beam,
                                  generator=torch.Generator().manual_seed(seed), device="cpu")
    assert _digest(fb) == want


def test_carver_needs_a_source_of_draws():
    with pytest.raises(ValueError):
        tc.generate_batch_device(8, 1, 8, device="cpu")


def test_prefill_needs_a_source_of_draws():
    """No draws and no generator: the prefill raises, as the carver does,
    instead of drawing from torch's global generator on the CPU."""
    with pytest.raises(ValueError):
        tf.prefill_boards_device(8, 4)
    with pytest.raises(ValueError):
        tf.prefill_boards_device(8, 4, device="cpu")


@pytest.mark.parametrize("n,cap,seed", sorted(PREFILL_DIGESTS))
def test_prefill_device_comes_from_the_generator(n, cap, seed):
    """Without ``device`` the prefill runs where its generator is, and its
    boards are word for word those recorded at the parent."""
    cols = tf.prefill_boards_device(n, cap, generator=torch.Generator().manual_seed(seed))
    assert cols.device.type == "cpu" and cols.dtype == torch.int32
    assert _digest([cols]) == PREFILL_DIGESTS[n, cap, seed]


@pytest.mark.parametrize("k", [8, 96])
def test_prefill_max_iters_matches_jax(k):
    n, cap = 64, 4
    key = jax.random.PRNGKey(k)
    want = np.asarray(jax.jit(jf.prefill_boards_device,
                              static_argnames=("n", "max_iters"))(
        key, n=n, initial_height_max=cap, max_iters=k))
    # the fori_loop body draws as the carver's loop does (gen/jax_forward.py:105-110)
    draws = tuple(torch.as_tensor(np.array(a)) for a in
                  _jax_carver_draws(key, n=n, iters=k, P=1)[:3])
    got = tf.prefill_boards_device(n, cap, max_iters=k, draws=draws)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    # longer draws: only the first max_iters iterations run
    longer = tuple(torch.cat([d, d]) for d in draws)
    np.testing.assert_array_equal(
        tf.prefill_boards_device(n, cap, max_iters=k, draws=longer).numpy(),
        want.astype(np.int32))
    with pytest.raises(ValueError):
        tf.prefill_boards_device(n, cap, max_iters=k + 1, draws=draws)


# The port's pool in a child process of its own: spawned workers re-import
# the script as ``__mp_main__``, and each job asserts that its worker has no
# torch loaded before it proves its seed.
_POOL_SCRIPT = textwrap.dedent("""
    import json, sys
    from tetris_piclim_tpu_torch.gen import pipeline
    from tetris_piclim_tpu_torch.gen.pipeline import _prove_one

    def probed(job):
        assert "torch" not in sys.modules, "a pipeline worker imported torch"
        return _prove_one(job)

    def games(gs):
        return [[g.seed, g.board.tolist(), g.sequence] for g in gs]

    if __name__ == "__main__":
        pipeline._prove_one = probed
        out = {ex: games(pipeline.generate_batch(1, 10, 0, 10, executor=ex, workers=2))
               for ex in ("process", "thread")}
        out["parent_torch"] = "torch" in sys.modules
        print(json.dumps(out))
""")


def test_generate_batch_process_pool_matches_threads_and_jax(tmp_path):
    script = tmp_path / "pool_probe.py"
    script.write_text(_POOL_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = [[g.seed, g.board.tolist(), g.sequence]
            for g in jax_generate_batch(1, 10, 0, 10)]
    assert want, "no winnable game in seeds 0-9"
    assert got["process"] == got["thread"] == want
    assert got["parent_torch"] is False
