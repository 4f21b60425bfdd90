"""The port stands alone: importing every module of
``tetris_piclim_tpu_torch`` and ``chip_smoke.py`` pulls in neither jax nor
the JAX package, entry points default to the GPU (and raise without one),
and ``chip_smoke.py`` fails, printing no result, without a card or without
the rest of the repo."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import tetris_piclim_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m in ("jax", "tetris_piclim_tpu") or m.startswith(("jax.", "tetris_piclim_tpu.")))
raised = []
if not __import__("torch").cuda.is_available():
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.utils.config import TrainConfig
    for call in (lambda: ConfigBank(2, 20, capacity=8), lambda: DQNTrainer(TrainConfig())):
        try:
            call()
        except RuntimeError as e:
            raised.append("CUDA" in str(e))
print(json.dumps({"modules": names, "bad": bad, "raised": raised}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax_and_defaults_to_cuda():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["modules"]) >= 15, res["modules"]
    assert res["bad"] == []
    if not torch.cuda.is_available():
        assert res["raised"] == [True, True]


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                             env=_env(), capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
