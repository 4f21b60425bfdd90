"""Model-FLOPs utilization (MFU) accounting.

Counterpart of ``tetris_piclim_tpu/utils/mfu.py``:
MFU = (model FLOPs the program runs) / (elapsed seconds x the card's peak
FLOP/s).

Peak. The table holds the dense BF16 tensor-core peak per card from
NVIDIA's data sheets, keyed by the name ``torch.cuda.get_device_name``
reports; the most specific key matches first. As in JAX, MFU is reported
against the BF16 peak even for float32 programs: it answers "how much of
the card's money rate does the program get". A device the table does not
know, the CPU included, has no peak (``None``), as JAX returns None off the
TPU. The data-sheet peaks assume the card's full power limit (700 W for the
SXM part); ``nvidia-smi`` says what a card is set to.

FLOPs. JAX takes them from XLA's cost model of the compiled executable.
Here :func:`counted_flops` runs the function once under
``torch.utils.flop_counter.FlopCounterMode``, which counts the model FLOPs
of matrix products and convolutions (forward, and backward when the
function runs one), 2 per multiply-add; element-wise work (bias adds, ReLU,
the optimizer) counts nothing. The two conventions differ slightly
(measured on the CPU, 4096 observations per forward):

================================  ======================  ================
network                           XLA ``compiled_flops``  ``counted_flops``
================================  ======================  ================
MLP 217 -> 4x128 -> 14            649,125,888             644,874,240
conv (32, 64) + dueling + joint   41,450,082,304          44,287,655,936
================================  ======================  ================

The MLP count here is exactly ``2 (217*128 + 3*128*128 + 128*14) N``; XLA's
is 0.66% more because it also counts bias adds and ReLUs. The conv count is
6.8% more than XLA's, most likely because XLA leaves out the zero-padded
taps of the 3x3 ``SAME`` convolutions on the 20x10 board, while the torch
convention counts every tap of every output. Neither count is adjusted to
the other.

Loops. As in JAX (whose cost model counts a scanned body once), count an
UNLOOPED single call and multiply by the known trip counts yourself.
"""

from __future__ import annotations

from typing import Optional

import torch

# dense BF16 tensor-core peak FLOP/s per card (NVIDIA data sheets)
_PEAK_BF16 = {
    "h100 80gb hbm3": 989.4e12,   # H100 SXM5
    "h100 pcie": 756e12,
}


def device_kind(device=None) -> str:
    """The card's name for a CUDA device (default: the current one when a
    card is present), else the device type (``"cpu"``)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def peak_flops(device=None) -> Optional[float]:
    """BF16 peak FLOP/s of ``device`` (default: see :func:`device_kind`), or
    None if the table does not know it."""
    kind = device_kind(device).lower()
    for k in sorted(_PEAK_BF16, key=len, reverse=True):
        if k in kind:
            return _PEAK_BF16[k]
    return None


def counted_flops(fn, *args, **kwargs) -> Optional[float]:
    """Model FLOPs of one call ``fn(*args, **kwargs)``, counted by
    ``FlopCounterMode`` (the call runs for real); None if it counts none.
    Count unlooped calls only (see the module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None


def mfu_from_flops(flops: float, elapsed_s: float, device=None) -> Optional[dict]:
    """MFU given a FLOP count and elapsed seconds; None when the peak is
    unknown or either number is not positive."""
    p = peak_flops(device)
    if p is None or elapsed_s <= 0 or flops <= 0:
        return None
    return {
        "flops": float(flops),
        "peak_flops": p,
        "mfu": float(flops) / (elapsed_s * p),
        "device_kind": device_kind(device),
    }


def mfu(fn, *args, elapsed_s: float, device=None, **kwargs) -> Optional[dict]:
    """MFU of one call of ``fn(*args, **kwargs)`` taking ``elapsed_s``
    seconds. Only valid for calls WITHOUT loops of their own (see
    :func:`mfu_from_flops`)."""
    f = counted_flops(fn, *args, **kwargs)
    if f is None:
        return None
    return mfu_from_flops(f, elapsed_s, device)
