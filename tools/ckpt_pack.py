"""Pack a checkpoint directory of ``cli train`` into one small file, and back.

    python3 tools/ckpt_pack.py pack CKPT_DIR FILE.ckpt.xz
    python3 tools/ckpt_pack.py unpack FILE.ckpt.xz CKPT_DIR

A flagship checkpoint (``state.pt`` and ``bank.pt``: online and target conv
weights, three AMSGrad moments, the 131072-row replay ring, envs, bank
rows) is ~47 MB, and a call to the card may bring back less than two of
them. ``pack`` loads every ``.pt`` file of the directory on the CPU, puts
each tensor's bytes into one blob (floating-point tensors byte-shuffled:
the k-th byte of every element together, so the sign-and-exponent bytes
compress well) and writes the blob, the structure around the tensors and
every other file of the directory as one xz stream. It then unpacks the
file in memory and raises unless every tensor and value comes back equal,
dtype and shape included. ``unpack`` writes the ``.pt`` files anew with
``torch.save``: the same tensors and values, so ``--resume`` from the
unpacked directory continues the run word for word (storage shared
between tensors is not kept; the restore copies every tensor anyway).
Prints one JSON line: the bytes before and after.
"""

from __future__ import annotations

import argparse
import io
import json
import lzma
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

_TENSOR = "__packed_tensor__"


def _strip(obj, blobs: list):
    """``obj`` with each tensor replaced by a reference to its bytes in
    ``blobs``."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        size = t.element_size()
        if t.is_floating_point() and size > 1:
            raw = raw.reshape(-1, size).T
        blobs.append(np.ascontiguousarray(raw).tobytes())
        return {_TENSOR: len(blobs) - 1, "dtype": str(t.dtype).split(".")[1],
                "shape": list(t.shape)}
    if isinstance(obj, dict):
        return {k: _strip(v, blobs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_strip(v, blobs) for v in obj)
    return obj


def _fill(obj, blobs: list):
    """The inverse of :func:`_strip`."""
    if isinstance(obj, dict) and _TENSOR in obj:
        dtype = getattr(torch, obj["dtype"])
        size = torch.empty(0, dtype=dtype).element_size()
        raw = np.frombuffer(blobs[obj[_TENSOR]], np.uint8)
        if not raw.size:
            return torch.empty(obj["shape"], dtype=dtype)
        if dtype.is_floating_point and size > 1:
            raw = raw.reshape(size, -1).T
        flat = torch.from_numpy(np.ascontiguousarray(raw).reshape(-1).copy()).view(dtype)
        return flat.reshape(obj["shape"])
    if isinstance(obj, dict):
        return {k: _fill(v, blobs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_fill(v, blobs) for v in obj)
    return obj


def same(a, b) -> bool:
    """Equal word for word: tensors by dtype, shape and bytes."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu().reshape(-1).view(torch.uint8),
                                b.cpu().reshape(-1).view(torch.uint8)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    return a == b


def _read(payload: bytes) -> dict:
    """name -> loaded ``.pt`` object, or the raw bytes of any other file."""
    files, blobs = pickle.loads(payload)
    return {name: _fill(obj, blobs) if name.endswith(".pt") else obj
            for name, obj in files.items()}


def pack(ckpt: str, out: str) -> dict:
    files, blobs, raw_bytes = {}, [], 0
    for path in sorted(Path(ckpt).iterdir()):
        raw_bytes += path.stat().st_size
        if path.suffix == ".pt":
            loaded = torch.load(path, map_location="cpu", weights_only=True)
            files[path.name] = _strip(loaded, blobs)
        else:
            files[path.name] = path.read_bytes()
    payload = pickle.dumps((files, blobs), protocol=pickle.HIGHEST_PROTOCOL)
    data = lzma.compress(payload, preset=9)
    back = _read(lzma.decompress(data))
    for name in files:
        orig = (torch.load(Path(ckpt) / name, map_location="cpu", weights_only=True)
                if name.endswith(".pt") else (Path(ckpt) / name).read_bytes())
        if not same(orig, back[name]):
            raise RuntimeError(f"{name} does not come back equal from the packed file")
    Path(out).write_bytes(data)
    return {"packed": out, "from": ckpt, "files": sorted(files),
            "bytes": raw_bytes, "packed_bytes": len(data)}


def read_packed(src) -> dict:
    """A packed file's contents in memory: name -> loaded ``.pt`` object
    (tensors on the CPU), or the raw bytes of any other file."""
    return _read(lzma.decompress(Path(src).read_bytes()))


def unpack(src: str, ckpt: str) -> dict:
    data = Path(src).read_bytes()
    os.makedirs(ckpt, exist_ok=True)
    for name, obj in _read(lzma.decompress(data)).items():
        if name.endswith(".pt"):
            buf = io.BytesIO()
            torch.save(obj, buf)
            obj = buf.getvalue()
        (Path(ckpt) / name).write_bytes(obj)
    return {"unpacked": ckpt, "from": src, "packed_bytes": len(data),
            "bytes": sum(p.stat().st_size for p in Path(ckpt).iterdir())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("op", choices=["pack", "unpack"])
    p.add_argument("src")
    p.add_argument("dst")
    a = p.parse_args(argv)
    res = (pack if a.op == "pack" else unpack)(a.src, a.dst)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
