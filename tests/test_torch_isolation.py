"""The port stands alone: importing every module of
``tetris_piclim_tpu_torch`` and ``chip_smoke.py`` pulls in neither jax nor
the JAX package, entry points default to the GPU (and raise without one),
the modules that spawned producer processes load (the refresh producers,
the host generators, ``env_api``) pull in neither torch nor jax, and
``chip_smoke.py`` fails, printing no result, without a card or without the
rest of the repo."""

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
    from tetris_piclim_tpu_torch.dqn.curriculum_train import CurriculumTrainer
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.utils.config import TrainConfig
    for call in (lambda: ConfigBank(2, 20, capacity=8), lambda: DQNTrainer(TrainConfig()),
                 lambda: CurriculumTrainer([(1, 8)])):
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
        assert res["raised"] == [True, True, True]


_PRODUCER_PROBE = r"""
import json, sys
from tetris_piclim_tpu_torch import env_api
from tetris_piclim_tpu_torch.gen import _producers, carver, minimize, pipeline
heavy = sorted(m for m in sys.modules
               if m.split(".")[0] in ("torch", "jax", "tetris_piclim_tpu", "triton"))
print(json.dumps(heavy))
"""


def test_producer_modules_load_no_torch():
    out = subprocess.run([sys.executable, "-c", _PRODUCER_PROBE], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


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


_TOOL_PROBE = r"""
import json, sys
sys.path.insert(0, "tools")
import learning_check
learning_check.parse([])
bad = sorted(m for m in sys.modules
             if m in ("jax", "tetris_piclim_tpu") or m.startswith(("jax.", "tetris_piclim_tpu.")))
print(json.dumps(bad))
"""


def test_learning_check_imports_no_jax_and_needs_a_card(tmp_path):
    out = subprocess.run([sys.executable, "-c", _TOOL_PROBE], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "tools/learning_check.py", "--steps", "2",
             "--out", str(tmp_path)], cwd=ROOT, env=_env(), capture_output=True,
            text=True, timeout=120)
        assert out.returncode != 0 and "CUDA" in out.stderr and out.stdout == ""
