"""Port conv torso and dueling heads against the JAX package: the same flax
parameters (through ``params_from_flax``) give the same Q on the same
observations, for the MLP's dueling heads and for ``ConvQNetwork`` over
impl (conv / im2col) x dueling x joint, the bottleneck, the pool and wider
channels, in float32 and with the bfloat16 torso; parameter counts agree and
the port's own init has flax's per-layer statistics."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_piclim_tpu.models.convnet import ConvQNetwork as JConvQNetwork
from tetris_piclim_tpu.models.qnet import QNetwork as JQNetwork
from tetris_piclim_tpu_torch.models import convnet as tconv
from tetris_piclim_tpu_torch.models.qnet import QNetwork, params_from_flax

# small tensors: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

F32_ATOL = 1e-4   # float32 Q, port vs JAX
BF16_ATOL = 5e-2  # the bfloat16 torso


def _obs(n=16, seed=0):
    rng = np.random.default_rng(seed)
    board = (rng.random((n, 200)) < 0.3).astype(np.float32)
    aux = np.zeros((n, 17), np.float32)
    aux[np.arange(n), rng.integers(0, 7, n)] = 1.0
    aux[np.arange(n), 7 + rng.integers(0, 7, n)] = 1.0
    aux[:, 14] = rng.integers(0, 11, n)
    aux[:, 15] = rng.integers(0, 31, n)
    return np.concatenate([board, aux], axis=1)


def _n_params(tree) -> int:
    return sum(x.size for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("dueling,joint", [(True, False), (True, True)])
def test_mlp_dueling_matches_flax(dueling, joint):
    obs = _obs()
    jnet = JQNetwork(dueling=dueling, joint=joint)
    jp = _with_biases(jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 217))), 1)
    tnet = QNetwork(dueling=dueling, joint=joint)
    tnet.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jp)))
    want = np.asarray(jnet.apply(jp, jnp.asarray(obs)))
    with torch.no_grad():
        got = tnet(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    assert _n_params(jp) == sum(p.numel() for p in tnet.parameters())
    # Dense_4 is the value head (width 1), Dense_5 the advantage head
    assert tnet.head.value.weight.shape == (1, 128)


_GRID = [dict(impl=i, dueling=d, joint=j)
         for i in ("conv", "im2col") for d in (False, True) for j in (False, True)]
_EXTRA = ([dict(impl=i, bottleneck=16) for i in ("conv", "im2col")]
          + [dict(impl=i, pool=2, dueling=True) for i in ("conv", "im2col")]
          + [dict(impl="conv", channels=(64, 128), joint=True)])
# float32 on every case; the bfloat16 torso on the flagship's dueling joint
# net of either impl and on the conv impl's bottleneck and pool
_CONV_CASES = ([(kw, False) for kw in _GRID + _EXTRA]
               + [(kw, True) for kw in _GRID if kw["dueling"] and kw["joint"]]
               + [(kw, True) for kw in _EXTRA[:4] if kw["impl"] == "conv"])


def _with_biases(jp, seed):
    """flax's init with nonzero biases, so their layout is checked too."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + rng.normal(0, 0.05, x.shape).astype(np.float32)
        if path[-1].key == "bias" else x, jp)


@functools.lru_cache(maxsize=None)
def _conv_params(kw_items):
    """flax's init of the net (parameters are float32 whatever the compute
    dtype), with nonzero biases; shared by a case's f32 and bf16 runs."""
    jnet = JConvQNetwork(**dict(kw_items))
    return _with_biases(jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, 217))), 2)


def _case_id(case):
    kw, bf16 = case
    return "-".join([f"{k}={v}" for k, v in kw.items()] + ["bf16" if bf16 else "f32"])


@pytest.mark.parametrize("kw,bf16", _CONV_CASES, ids=[_case_id(c) for c in _CONV_CASES])
def test_convnet_matches_flax(kw, bf16):
    obs = _obs()
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jnet = JConvQNetwork(dtype=jdtype, **kw)
    jp = _conv_params(tuple(kw.items()))
    tnet = tconv.ConvQNetwork(dtype=tdtype, **kw)
    tnet.load_state_dict(tconv.params_from_flax(jax.tree.map(np.asarray, jp), tnet))
    want = np.asarray(jnet.apply(jp, jnp.asarray(obs)))
    with torch.no_grad():
        got = tnet(torch.as_tensor(obs))
    assert got.dtype == torch.float32  # the Q head is always float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_ATOL if bf16 else F32_ATOL)
    assert _n_params(jp) == sum(p.numel() for p in tnet.parameters())


def test_convnet_flatten_order_is_nhwc():
    """The JAX net's first Dense layer reads its features in (h, w, c)
    order (``convnet.py:106``): feature (c, h, w) of the last conv sits at
    ``(h * 10 + w) * C + c`` of the port's flattened input too, which an
    NCHW flatten would put at ``c * 200 + h * 10 + w``."""
    tnet = tconv.ConvQNetwork(channels=(2, 3),
                              generator=torch.Generator().manual_seed(0))
    obs = torch.as_tensor(_obs(4))
    with torch.no_grad():
        flat = tnet.features(obs)
        fmap = obs[:, :200].reshape(4, 1, 20, 10)
        for conv in tnet.convs:
            fmap = torch.relu(conv(fmap))
    assert flat.shape == (4, 200 * 3 + 17)
    want = fmap.permute(0, 2, 3, 1).reshape(4, 200, 3)
    np.testing.assert_array_equal(flat[:, :600].reshape(4, 200, 3).numpy(),
                                  want.numpy())
    np.testing.assert_array_equal(flat[:, 600:].numpy(), obs[:, 200:].numpy())
    h, x, c = 7, 4, 2
    assert flat[0, (h * 10 + x) * 3 + c] == fmap[0, c, h, x]


@pytest.mark.parametrize("kw", [dict(dueling=True, joint=True),
                                dict(bottleneck=16, dueling=True)],
                         ids=["dueling-joint", "bottleneck"])
def test_convnet_init_statistics_match_flax(kw):
    """flax's init, layer by layer: lecun-normal truncated kernels with the
    fan-in of the layer (kh * kw * Cin for a conv), zero biases. The port's
    per-layer standard deviations sit where flax's do."""
    jnet = JConvQNetwork(**kw)
    jp = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, 217))))
    tnet = tconv.ConvQNetwork(generator=torch.Generator().manual_seed(3), **kw)
    want = tconv.params_from_flax(jp, tnet)   # flax's init in the port's layout
    got = tnet.state_dict()
    assert set(got) == set(want)
    for name, p in got.items():
        p, w = p.numpy(), want[name].numpy()
        if name.endswith("bias"):
            assert not p.any() and not w.any(), name
            continue
        fan_in = int(np.prod(p.shape[1:]))
        std = np.sqrt(1.0 / fan_in)
        tol = max(0.1, 4.0 / np.sqrt(p.size))
        assert abs(p.std() / std - 1.0) < tol, (name, p.std(), std)
        assert abs(w.std() / std - 1.0) < tol, (name, w.std(), std)
        assert np.abs(p).max() <= 2 * std / 0.87962566103423978 + 1e-6, name
