"""The port's tools run end to end at tiny sizes on the CPU:
``tools/ckpt_pack.py`` (a checkpoint packed and unpacked word for word). The
numbers are CPU numbers and mean nothing; the shapes of the results are
checked."""

import json
import sys
from pathlib import Path

import torch
from torch_port_helpers import tiny_run

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


def test_ckpt_pack_round_trip(tmp_path, capsys):
    """``tools/ckpt_pack.py``: a trainer checkpoint packed and unpacked
    loads back word for word (weights, moments, ring, envs, generators,
    counters, bank rows), and is smaller than the directory."""
    import ckpt_pack

    _, ckpt, _ = tiny_run(tmp_path)
    packed = tmp_path / "ckpt.xz"
    assert ckpt_pack.main(["pack", ckpt, str(packed)]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["files"] == ["bank.pt", "state.pt"]
    assert res["packed_bytes"] == packed.stat().st_size < res["bytes"]
    back = tmp_path / "back"
    assert ckpt_pack.main(["unpack", str(packed), str(back)]) == 0
    for name in ("state.pt", "bank.pt"):
        a = torch.load(Path(ckpt) / name, weights_only=True)
        b = torch.load(back / name, weights_only=True)
        assert ckpt_pack.same(a, b)
    a = torch.load(Path(ckpt) / "state.pt", weights_only=True)
    assert a["global_step"] == 0 and a["replay"] and a["opt"] and a["gen"].dtype == torch.uint8
    # the check sees a flipped bit, a dtype and a container type
    w = next(iter(a["net"].values()))
    flipped = w.clone()
    flipped.view(-1).view(torch.int32)[0] ^= 1
    assert not ckpt_pack.same(w, flipped)
    assert not ckpt_pack.same(w, w.double())
    assert not ckpt_pack.same([1, 2], (1, 2))
