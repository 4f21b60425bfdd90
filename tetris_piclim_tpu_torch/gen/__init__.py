"""Initial-configuration generators for Tetris-piclim (counterpart of
``tetris_piclim_tpu.gen``): the seeded forward generator and its greedy DFS
prover, the carver, the host pipeline, the device bank with its refresh,
and the device carver and forward prover (``device_carver``,
``device_forward``). Exports are lazy (see the package ``__init__``)."""

from .._lazy import lazy_exports

__getattr__, __dir__, __all__ = lazy_exports(__name__, {
    ".forward": ["ForwardGenerator", "generate_board_and_sequence"],
    ".solver": ["GreedyDFSSolver"],
    ".carver": ["CarvingGenerator"],
    ".pipeline": ["generate_batch", "translate_batch"],
    ".bank": ["ConfigBank"],
})
