"""The port's tools run end to end at tiny sizes on the CPU:
``tools/trainer_profile.py``, which needs a card and refuses to run without
one. The numbers are CPU numbers and mean nothing; the shapes of the results
are checked."""

import sys
from pathlib import Path

import pytest
import torch
from torch_port_helpers import run_tool

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


def test_trainer_profile_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run at full size")
    out = run_tool(["tools/trainer_profile.py"], timeout=120)
    assert out.returncode == 1 and "CUDA is not available" in out.stderr
