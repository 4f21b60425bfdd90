"""Q-networks (counterpart of ``tetris_piclim_tpu.models``): the MLP with
its factored and joint heads; the conv torso is ``models/convnet.py``.
Exports are lazy (see the package ``__init__``)."""

from .._lazy import lazy_exports

__getattr__, __dir__, __all__ = lazy_exports(__name__, {
    ".qnet": ["QNetwork", "FactoredQ", "JointQ", "q_ops", "init_qnet"],
})
