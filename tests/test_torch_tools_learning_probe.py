"""The port's tools run end to end at tiny sizes on the CPU:
``tools/learning_probe.py`` (either package's trainer; ``--jax-root`` here
on a stub package; ``--summarize``). The numbers are CPU numbers and mean
nothing; the shapes of the results are checked."""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch_port_helpers import run_tool

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


# a JAX package in name only: records the TrainConfig fields it is given
_STUB = {
    "__init__.py": "",
    "dqn/__init__.py": "",
    "gen/__init__.py": "",
    "utils/__init__.py": "",
    "utils/config.py": (
        "class EnvConfig:\n"
        "    def __init__(self, L, M):\n        self.L, self.M = L, M\n"
        "class TrainConfig:\n"
        "    def __init__(self, *, env, num_envs, bank_capacity, replay_capacity,\n"
        "                 total_steps, log_every, seed):\n"
        "        self.num_envs, self.steps, self.log_every = num_envs, total_steps, log_every\n"),
    "gen/bank.py": (
        "class ConfigBank:\n"
        "    def __init__(self, L, M, capacity, seed):\n        pass\n"
        "    def fill_device(self):\n        return self\n"),
    "dqn/train.py": (
        "class DQNTrainer:\n"
        "    def __init__(self, cfg, bank):\n        self.cfg = cfg\n"
        "    def train(self, log_fn):\n"
        "        c = self.cfg\n"
        "        return {'history': [{'env_steps': s * c.num_envs, 'win_rate': 0.25,\n"
        "                             'loss': 0.5} for s in range(c.log_every, c.steps + 1,\n"
        "                                                        c.log_every)]}\n"
        "    def evaluate(self, n_episodes):\n        return {'win_rate': 0.75}\n"),
}


def test_learning_probe_jax_root(tmp_path):
    """``--jax-root DIR`` runs the package found in DIR, passing only the
    TrainConfig fields an old version has, and names DIR and its commit."""
    pkg = tmp_path / "tetris_piclim_tpu"
    for name, text in _STUB.items():
        (pkg / name).parent.mkdir(parents=True, exist_ok=True)
        (pkg / name).write_text(text)
    (tmp_path / "COMMIT").write_text("b5c6e5a259db87eb62a2de0188d003336b547d42\n")
    args = ["tools/learning_probe.py", "--device", "cpu", "--num-envs", "8",
            "--steps", "20", "--log-every", "10", "--seeds", "3"]
    out = run_tool([*args, "--package", "jax", "--jax-root", str(tmp_path)], timeout=60)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax_root"] == str(tmp_path)
    assert res["jax_commit"] == "b5c6e5a259db87eb62a2de0188d003336b547d42"
    assert res["env_steps"] == [80, 160] and res["win_rate"] == [0.25, 0.25]
    assert res["greedy_win_rate"] == 0.75 and res["seed"] == 3
    out = run_tool([*args, "--jax-root", str(tmp_path)], timeout=60)
    assert out.returncode != 0 and "--jax-root is for --package jax" in out.stderr
    (tmp_path / "COMMIT").unlink()
    (pkg / "__init__.py").unlink()  # not a package: the checkout's is found
    out = run_tool([*args, "--package", "jax", "--jax-root", str(tmp_path)], timeout=60)
    assert out.returncode != 0 and "tetris_piclim_tpu came from" in out.stderr


def test_learning_probe_summarize(tmp_path):
    """``--summarize``: runs that differ only in their seed become one set,
    each chunk as mean, sample sd and lowest."""
    base = {"tool": "learning_probe", "package": "jax", "matmul": "f32",
            "jax_root": None, "jax_commit": None, "device": "cpu", "card": None,
            "num_envs": 8, "bank": 8, "replay": 64, "steps": 20,
            "env_steps": [80, 160], "loss": [0.1, 0.1], "wall_s": 1.0}
    runs = [dict(base, seed=s, win_rate=w, greedy_win_rate=g)
            for s, w, g in ((0, [0.1, 0.3], 0.5), (1, [0.3, 0.5], 0.7))]
    runs.append(dict(base, seed=0, package="torch", win_rate=[0.2, 0.2],
                     greedy_win_rate=0.1))
    path = tmp_path / "runs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in runs))
    out = run_tool(["tools/learning_probe.py", "--summarize", str(path)], timeout=60)
    assert out.returncode == 0, out.stderr
    jax_set, torch_set = [json.loads(line) for line in out.stdout.splitlines()]
    assert jax_set["seeds"] == [0, 1] and torch_set["seeds"] == [0]
    assert jax_set["win_rate_mean"] == pytest.approx([0.2, 0.4])
    assert jax_set["win_rate_sd"] == pytest.approx([0.1 * 2 ** 0.5] * 2)
    assert jax_set["win_rate_min"] == pytest.approx([0.1, 0.3])
    assert jax_set["greedy_mean"] == pytest.approx(0.6)
    assert torch_set["win_rate_sd"] == [0.0, 0.0] and torch_set["greedy_sd"] == 0.0
