"""Configs, checkpoints, metrics, profiling and MFU accounting (counterpart
of ``tetris_piclim_tpu.utils``). Exports are lazy (see the package
``__init__``)."""

from .._lazy import lazy_exports

__getattr__, __dir__, __all__ = lazy_exports(__name__, {
    ".config": ["DQNConfig", "EnvConfig", "TrainConfig"],
})
