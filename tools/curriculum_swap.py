"""One part of the JAX package's curriculum run swapped into the port's.

    python3 -c "import sys; sys.path.insert(0, 'tools'); import curriculum_swap; \
        curriculum_swap.apply('banks'); from tetris_piclim_tpu_torch.cli import main; \
        sys.exit(main())" curriculum --levels ... --seed S --device cpu

``tools/curriculum_check.py --swap PART`` runs the port's ``cli
curriculum`` this way, labelled ``port_swap_PART``. ``apply`` reads the
command line as ``cli curriculum`` will, splits ``PRNGKey(seed)`` as JAX's
``CurriculumTrainer`` does (``key, k_bank, k_env, k_init``), and makes the
port's trainer take that part from JAX:

* ``banks``: the level banks JAX builds from ``k_bank``
  (``build_curriculum_bank``), as a port ``CurriculumBank``;
* ``init``: the initial weights flax draws from ``k_init`` (the target a
  copy of them, as in both packages);
* ``draws``: every draw of the trainer's own generator, JAX's instead: the
  first envs' bank rows from ``k_env`` (in place of the port's own), then
  per step the explore
  uniforms, random rotations and columns (``k_act`` split three ways),
  the reset rows (``k_step``) and each update's replay offsets
  (``k_sample`` split into ``updates_per_step`` keys), in the order the
  port draws them (``tests/test_torch_curriculum_chunk_vs_jax.py`` holds
  that order word for word). Uniform replay only.

Everything else stays the port's. With all three swapped, the port's run
is JAX's run, row for row while float32 sum order keeps them together
(``tests/test_torch_curriculum_check.py``). This is the tools' one path besides
``--package jax`` that imports JAX; it runs on the CPU.
"""

from __future__ import annotations

import os
import sys

PARTS = ("banks", "init", "draws")


def _port_bank(jb):
    import numpy as np
    import torch

    from tetris_piclim_tpu_torch.gen import curriculum as cur

    return cur.CurriculumBank(*(torch.as_tensor(np.array(x).astype(d)) for x, d in zip(
        jb, (np.int32, np.int8, np.int32, np.int32))))


class JaxDraws:
    """Stands in for ``torch.rand`` / ``torch.randint`` on the trainer's
    generator: JAX's draws, in the port's order, from the key stream of
    JAX's ``CurriculumTrainer``."""

    def __init__(self, key, updates: int):
        self.key, self.updates = key, updates
        self.gen, self.queue, self.samples = None, [], []

    def rand(self, n: int, device=None):
        import jax

        self.key, k_act, k_step, k_sample = jax.random.split(self.key, 4)
        k_expl, k_rot, k_col = jax.random.split(k_act, 3)
        self.queue = [(4, k_rot), (10, k_col), (None, k_step)]
        self.samples = list(jax.random.split(k_sample, self.updates))
        return _tensor(jax.random.uniform(k_expl, (n,)), device)

    def randint(self, low, high, size, device=None):
        import jax

        if self.queue:
            want, key = self.queue.pop(0)
            if want is not None and want != high:
                raise RuntimeError(f"draw order: asked randint(0, {high}), JAX's {want}")
        else:
            key = self.samples.pop(0)
        return _tensor(jax.random.randint(key, tuple(size), low, high), device)


def _tensor(x, device):
    import numpy as np
    import torch

    x = np.array(x)
    return torch.from_numpy(x).to(device=device, dtype=(
        torch.float32 if x.dtype.kind == "f" else torch.int64))


def apply(parts: str, argv=None) -> None:
    """Patch the port so that ``cli curriculum`` with ``argv`` (default
    ``sys.argv[1:]``) takes each of ``parts`` (comma-separated) from JAX."""
    parts = parts.split(",")
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"--swap takes {PARTS}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import torch

    from tetris_piclim_tpu_torch import cli
    from tetris_piclim_tpu_torch.dqn import curriculum_train

    args = cli.build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    key, k_bank, k_env, k_init = jax.random.split(jax.random.PRNGKey(args.seed), 4)
    levels = [tuple(int(x) for x in pair.split(":")) for pair in args.levels.split(",")]
    if "banks" in parts:
        from tetris_piclim_tpu.gen import curriculum as jcur

        bank = _port_bank(jcur.build_curriculum_bank(k_bank, levels, capacity=args.bank))
        curriculum_train.cur_lib.build_curriculum_bank = (
            lambda *a, device=None, **k: cur_to(bank, device))
    if "init" in parts:
        import jax.numpy as jnp

        from tetris_piclim_tpu.models.qnet import QNetwork as JNet
        from tetris_piclim_tpu_torch.models.qnet import QNetwork, params_from_flax

        if args.model != "mlp" or args.dueling or args.joint:
            raise SystemExit("--swap init takes the MLP")
        net = QNetwork()
        net.load_state_dict(params_from_flax(
            JNet().init(k_init, jnp.zeros((1, 217), jnp.float32))))
        cli._net = lambda args, seed: net
    if "draws" in parts:
        feed = JaxDraws(key, args.updates)
        init = curriculum_train.CurriculumTrainer.__init__
        rand, randint = torch.rand, torch.randint

        def trainer_init(self, *a, **kw):
            init(self, *a, **kw)
            # a generator of its own marks the trainer's draws; the first
            # envs take the rows JAX draws from k_env
            feed.gen = self.state.gen = torch.Generator(device=self.device)
            rows = _tensor(jax.random.randint(
                k_env, (self.cfg.num_envs,), 0, self.bank.boards.shape[1]), self.device)
            self.state.env = curriculum_train.cur_lib.make_states(
                self.bank, torch.as_tensor(self.level, device=self.device), rows)

        def fed_rand(*size, generator=None, device=None, **kw):
            if generator is None or generator is not feed.gen:
                return rand(*size, generator=generator, device=device, **kw)
            return feed.rand(size[0][0], device)

        def fed_randint(low, high, size, generator=None, device=None, **kw):
            if generator is None or generator is not feed.gen:
                return randint(low, high, size, generator=generator, device=device, **kw)
            return feed.randint(low, high, size, device)

        curriculum_train.CurriculumTrainer.__init__ = trainer_init
        torch.rand, torch.randint = fed_rand, fed_randint


def cur_to(bank, device):
    from tetris_piclim_tpu_torch.gen import curriculum as cur

    return cur.CurriculumBank(*(x.to(device) for x in bank))
