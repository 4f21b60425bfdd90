"""Convolutional Q-network: a conv torso over the 20x10 board, then an MLP.

Counterpart of ``tetris_piclim_tpu/models/convnet.py``, the torso of the
README's flagship recipe (``--model conv --dueling --joint``). Per
observation: the 200 board cells as a [1, 20, 10] image, 3x3 convolutions
(``SAME`` padding) with ReLU for each entry of ``channels``, then an
optional ``pool`` x ``pool`` max-pool (stride ``pool``, ``VALID``) and an
optional 1x1 ``bottleneck`` convolution with ReLU, a flatten, the 17 aux
features appended, two ``hidden``-wide Dense layers with ReLU and the Q head
(:class:`.qnet.QHead`, plain or dueling, always float32).

Layouts. The JAX net flattens its NHWC feature map, so its first Dense layer
reads the features in (h, w, c) order; this net permutes its NCHW map to
NHWC before the flatten, so the Dense weights carry across as they are.
A flax ``Conv`` kernel is HWIO ``[3, 3, Cin, Cout]``, a torch weight
``[Cout, Cin, 3, 3]``.

``impl``. The JAX package has two lowerings of the same math: ``"conv"``
(``nn.Conv``) and ``"im2col"`` (explicit 3x3 patches into ``nn.Dense``
layers, whose kernels ``[9 * Cin, Cout]`` order the patch features (c, kh,
kw), channel outermost, as ``F.unfold`` does). This port runs one conv code
path (``F.conv2d``, cuDNN on the card) for both, and
:func:`params_from_flax` reads either JAX tree into it:
``W[o, c, kh, kw] = K[c * 9 + kh * 3 + kw, o]``. ``impl`` is kept as an
attribute only so that a net states which JAX tree it mirrors; port
checkpoints load whatever ``impl`` says.

``dtype=torch.bfloat16`` (``--bf16``): the torso's products and bias adds
run in bf16 from float32 parameters; the activations go back to float32
before the head, as in the JAX net.

TF32. PyTorch's default lets cuDNN run float32 convolutions in TF32 on the
card (``torch.backends.cudnn.allow_tf32`` is True) and keeps float32 matrix
products in full float32 (``torch.backends.cuda.matmul.allow_tf32`` is
False). The trainer keeps these defaults and sets neither; the JAX
reference's float32 convolutions on its TPU ran at the default precision,
a single bf16 pass, which is coarser than TF32. Checks of the card against
the CPU turn TF32 off first.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..engine import OBS_DIM
from .qnet import QHead, dense_from_flax, head_from_flax, lecun_normal_

BOARD_H, BOARD_W = 20, 10
AUX_DIM = OBS_DIM - BOARD_H * BOARD_W  # 17


def _conv(cin: int, cout: int, k: int, generator) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, padding=k // 2)
    lecun_normal_(conv.weight, cin * k * k, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _linear(cin: int, cout: int, generator) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    lecun_normal_(lin.weight, cin, generator)
    nn.init.zeros_(lin.bias)
    return lin


class ConvQNetwork(nn.Module):
    """Conv torso over the board + MLP over the aux features (see the
    module docstring). Built on the CPU; move it with ``.to``."""

    def __init__(self, channels: Sequence[int] = (32, 64), hidden: int = 128,
                 dueling: bool = False, joint: bool = False,
                 dtype: torch.dtype = torch.float32, impl: str = "conv",
                 bottleneck: int = 0, pool: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        if impl not in ("conv", "im2col"):
            raise ValueError(f"unknown conv impl {impl!r}")
        self.channels = tuple(int(c) for c in channels)
        self.joint, self.dueling = joint, dueling
        self.dtype, self.impl = dtype, impl
        self.pool, self.bottleneck = pool, bottleneck
        cins = (1,) + self.channels[:-1]
        self.convs = nn.ModuleList(
            _conv(a, b, 3, generator) for a, b in zip(cins, self.channels))
        c = self.channels[-1]
        self.narrow = _conv(c, bottleneck, 1, generator) if bottleneck else None
        c = bottleneck or c
        flat = (BOARD_H // pool) * (BOARD_W // pool) * c
        self.dense = nn.ModuleList([_linear(flat + AUX_DIM, hidden, generator),
                                    _linear(hidden, hidden, generator)])
        self.head = QHead(hidden, joint, dueling, generator)

    def _cast(self, layer: nn.Module):
        return layer.weight.to(self.dtype), layer.bias.to(self.dtype)

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        """The first Dense layer's input: the conv feature map flattened in
        (h, w, c) order, then the 17 aux features; in ``self.dtype``."""
        n = obs.shape[0]
        x = obs[:, :BOARD_H * BOARD_W].reshape(n, 1, BOARD_H, BOARD_W)
        x = x.to(self.dtype)
        for conv in self.convs:
            x = torch.relu(F.conv2d(x, *self._cast(conv), padding=1))
        if self.pool > 1:
            x = F.max_pool2d(x, self.pool, self.pool)
        if self.narrow is not None:
            x = torch.relu(F.conv2d(x, *self._cast(self.narrow)))
        x = x.permute(0, 2, 3, 1).reshape(n, -1)   # NHWC flatten, as in JAX
        return torch.cat([x, obs[:, BOARD_H * BOARD_W:].to(self.dtype)], dim=1)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = self.features(obs)
        for layer in self.dense:
            x = torch.relu(F.linear(x, *self._cast(layer)))
        return self.head(x.float())


def _arr(a) -> np.ndarray:
    return np.array(a, dtype=np.float32)


def params_from_flax(np_params, net: ConvQNetwork) -> dict[str, torch.Tensor]:
    """A state_dict for ``net`` from flax ConvQNetwork params of either
    impl (numpy or jax arrays). The tree says which impl wrote it: the
    conv impl's ``Conv_0`` is 3x3; the im2col impl's 3x3 layers are
    ``Dense_0 .. Dense_{n-1}``, so its later Dense names shift by n and its
    bottleneck (if any) is ``Conv_0``."""
    p = np_params["params"] if "params" in np_params else np_params
    n = len(net.channels)
    im2col = not ("Conv_0" in p and np.shape(p["Conv_0"]["kernel"])[0] == 3)
    out = {}
    cins = (1,) + net.channels[:-1]
    for i, cin in enumerate(cins):
        if im2col:
            k = _arr(p[f"Dense_{i}"]["kernel"])            # [9 * cin, cout]
            w = k.T.reshape(k.shape[1], cin, 3, 3)
            b = _arr(p[f"Dense_{i}"]["bias"])
        else:
            w = _arr(p[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)
            b = _arr(p[f"Conv_{i}"]["bias"])
        out[f"convs.{i}.weight"] = torch.as_tensor(w.copy())
        out[f"convs.{i}.bias"] = torch.as_tensor(b)
    if net.bottleneck:
        c = p["Conv_0" if im2col else f"Conv_{n}"]
        out["narrow.weight"] = torch.as_tensor(
            _arr(c["kernel"]).transpose(3, 2, 0, 1).copy())
        out["narrow.bias"] = torch.as_tensor(_arr(c["bias"]))
    d0 = n if im2col else 0
    for i in range(2):
        out[f"dense.{i}.weight"], out[f"dense.{i}.bias"] = dense_from_flax(
            p[f"Dense_{d0 + i}"])
    out.update(head_from_flax(p, d0 + 2, "head.", net.dueling))
    return out
