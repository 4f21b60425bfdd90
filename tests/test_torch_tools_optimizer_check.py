"""The port's tools run end to end at tiny sizes on the CPU:
``tools/optimizer_check.py`` (the learner's optimizer as loops against the
package's foreach version, word for word). The numbers are CPU numbers and
mean nothing; the shapes of the results are checked."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

torch.set_num_threads(1)


def test_optimizer_check_arms_agree_word_for_word():
    """``tools/optimizer_check.py``'s two arms on a toy conv learner from
    one seed: the optimizer and Polyak steps as loops over the tensors and
    the package's foreach versions end every chunk with the same weights,
    target weights and moments word for word; the loops are patched in for
    one chunk only; a changed word is reported."""
    import optimizer_check as oc

    from tetris_piclim_tpu_torch.dqn import agent
    from tetris_piclim_tpu_torch.dqn.train import DQNTrainer
    from tetris_piclim_tpu_torch.gen.bank import ConfigBank
    from tetris_piclim_tpu_torch.models.convnet import ConvQNetwork
    from tetris_piclim_tpu_torch.utils.config import EnvConfig, TrainConfig

    def toy():
        cfg = TrainConfig(env=EnvConfig(L=1, M=8), num_envs=16, bank_capacity=16,
                          replay_capacity=1024, warmup_steps=32, updates_per_step=4,
                          seed=0)
        bank = ConfigBank(1, 8, capacity=16, seed=0, device="cpu").fill_device()
        net = ConvQNetwork(channels=(4, 8), dueling=True, joint=True,
                           generator=torch.Generator().manual_seed(0))
        return DQNTrainer(cfg, bank=bank, net=net, device="cpu")

    loop, foreach = toy(), toy()
    for _ in range(2):
        oc.run_chunk(loop, "loop", 8)
        assert agent.AmsgradW.step is oc.ARMS["foreach"][0]
        assert agent.polyak is oc.ARMS["foreach"][1]
        oc.run_chunk(foreach, "foreach", 8)
        assert oc.apart(loop, foreach) == []
    assert loop.state.opt.count == foreach.state.opt.count >= 4 * 8
    assert len(oc.state_words(loop)) == 60
    with torch.no_grad():
        foreach.state.opt.nu_max[4].view(-1)[0] += 1.0
    assert oc.apart(loop, foreach) == ["nu_max.4"]
