"""Data-parallel training over ``torch.distributed`` (counterpart of
``tetris_piclim_tpu.parallel``): the mesh and the trainer's layout on it
(``mesh.py``), process-group start-up (``distributed.py``) and the
multi-process dry run (``dryrun.py``). Exports are lazy (see the package
``__init__``)."""

from .._lazy import lazy_exports

__getattr__, __dir__, __all__ = lazy_exports(__name__, {
    ".mesh": ["make_mesh", "shard_train_state", "replicate", "batch_sharding",
              "shard_bank"],
    ".distributed": ["init_distributed", "sync_hosts"],
    ".dryrun": ["dryrun_multigpu"],
})
