"""Fixed-shape compute paths (counterpart of ``tetris_piclim_tpu.ops``):
``bitboard``, the packed-bitboard env step, and the CUDA kernels' wrappers
(``rollout``, ``actor``). Exports are lazy (see the package ``__init__``)."""

from .._lazy import lazy_exports

__getattr__, __dir__, __all__ = lazy_exports(__name__, {".bitboard": []})
