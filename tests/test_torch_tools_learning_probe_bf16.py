"""The port's tools run end to end at tiny sizes on the CPU:
``tools/learning_probe.py``'s matmul modes (the bfloat16 forward-and-
backward ``nn.Linear``). The numbers are CPU numbers and mean nothing; the
shapes of the results are checked."""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch_port_helpers import run_tool

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


@pytest.mark.parametrize("matmul", ["f32", "bf16", "bf16-fwd-bwd"])
def test_learning_probe_small(matmul):
    """The probe at a tiny size; bf16 rounds every Linear's operands."""
    out = run_tool(["tools/learning_probe.py", "--device", "cpu", "--num-envs", "32",
                 "--bank", "16", "--replay", "1024", "--steps", "200",
                 "--log-every", "100", "--eval-episodes", "32", "--seeds", "0,1",
                 "--matmul", matmul], timeout=150)
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [r["seed"] for r in rows] == [0, 1]
    for r in rows:
        assert r["matmul"] == matmul and r["card"] is None
        assert r["env_steps"] == [3200, 6400] and len(r["win_rate"]) == 2
        assert 0 <= r["greedy_win_rate"] <= 1


def test_learning_probe_bf16_linear_is_one_bf16_pass():
    import learning_probe

    lin = torch.nn.Linear(7, 3)
    x = torch.randn(5, 7)
    forward = torch.nn.Linear.forward
    try:
        learning_probe.round_linear_inputs_to_bf16()
        got = lin(x)
    finally:
        torch.nn.Linear.forward = forward
    want = x.bfloat16().double() @ lin.weight.bfloat16().double().T + lin.bias.double()
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    assert not torch.equal(got, lin(x))


@pytest.mark.parametrize("shape", [(5, 7), (2, 3, 7)])
def test_bf16_fwd_bwd_linear_gradients(shape):
    """``Bf16Linear``: the forward product and both backward products are
    float32 products of bfloat16-rounded operands (the bias stays float32),
    checked against the same products in float64 on the rounded operands,
    and against plain float32, which they must differ from."""
    import learning_probe

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen, requires_grad=True)
    w = torch.randn(3, 7, generator=gen, requires_grad=True)
    b = torch.randn(3, generator=gen, requires_grad=True)
    g = torch.randn(*shape[:-1], 3, generator=gen)
    out = learning_probe.Bf16Linear.apply(x, w, b)
    out.backward(g)
    r = lambda t: t.detach().bfloat16().double()  # noqa: E731
    want_out = r(x) @ r(w).T + b.detach().double()
    want_gx = r(g) @ r(w)
    want_gw = r(g).reshape(-1, 3).T @ r(x).reshape(-1, 7)
    want_gb = g.double().reshape(-1, 3).sum(0)
    for got, want in ((out, want_out), (x.grad, want_gx), (w.grad, want_gw),
                      (b.grad, want_gb)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    # plain float32 autograd on the unrounded operands gives other gradients
    x32, w32 = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    torch.nn.functional.linear(x32, w32, b.detach()).backward(g)
    assert not torch.allclose(x.grad, x32.grad, rtol=0, atol=1e-6)
    assert not torch.allclose(w.grad, w32.grad, rtol=0, atol=1e-6)

    lin = torch.nn.Linear(7, 3)
    forward = torch.nn.Linear.forward
    try:
        learning_probe.round_linear_fwd_bwd_to_bf16()
        y = lin(x.detach())
    finally:
        torch.nn.Linear.forward = forward
    torch.testing.assert_close(y, learning_probe.Bf16Linear.apply(
        x.detach(), lin.weight, lin.bias), rtol=0, atol=0)
