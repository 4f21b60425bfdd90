"""PyTorch/CUDA port of tetris_piclim_tpu for NVIDIA Hopper GPUs.

Plain tensor code is PyTorch; the two kernels the JAX package wrote in
Pallas are CUDA C++ (``csrc/``), built with nvcc at first use and bound
with ctypes (``ops/_build.py``). Every kernel has a plain PyTorch version
beside it, which the CPU runs and the tests hold against the JAX package.
This package imports neither jax nor ``tetris_piclim_tpu``.

The top level re-exports the JAX package's names: the array engine
(``engine.py``, batch first, so ``step_batch`` and ``observe_batch`` are
aliases of ``step`` and ``observe``), ``tables`` and ``__version__``. The
exports are lazy (``_lazy.py``): importing the package loads no torch
until a torch-backed name is read, because spawned producer processes
import it. What differs from the JAX package's names:

* ``dqn``: the replay is a class, ``ReplayBuffer``, with methods in place
  of JAX's functional ``ReplayState`` / ``replay_init`` / ``replay_add`` /
  ``replay_sample`` / ``replay_sample_ext`` / ``replay_update_priority``;
* ``models.init_qnet`` takes a ``torch.Generator`` and returns the module
  alone (it holds its parameters);
* ``parallel`` (meshes, multi-device training) is not ported yet.
"""

from ._lazy import lazy_exports

__version__ = "0.1.0"

__getattr__, __dir__, __all__ = lazy_exports(__name__, {
    ".tables": [],
    ".engine": ["EnvState", "StepResult", "OBS_DIM", "RUNNING", "WIN", "LOSS",
                "make_state", "make_state_batch", "observe", "observe_batch",
                "step", "step_batch", "step_autoreset_batch"],
})
