"""Working DQN for Tetris-piclim: the epsilon-greedy actor, the replay, the
Huber TD learner with AdamW(amsgrad) and Polyak, and the trainers
(counterpart of ``tetris_piclim_tpu.dqn``).

The replay is a class, :class:`ReplayBuffer`: its ``add`` /
``add_fields`` / ``sample`` / ``sample_ext`` / ``update_priority`` methods
take the place of JAX's functional ``ReplayState``, ``replay_init``,
``replay_add``, ``replay_sample``, ``replay_sample_ext`` and
``replay_update_priority``, which are not exported here. Exports are lazy
(see the package ``__init__``)."""

from .._lazy import lazy_exports

__getattr__, __dir__, __all__ = lazy_exports(__name__, {
    ".replay": ["ReplayBuffer"],
    ".agent": ["select_actions", "td_loss", "make_optimizer", "eps_schedule",
               "learner_update"],
    ".train": ["DQNTrainer", "TrainState"],
})
