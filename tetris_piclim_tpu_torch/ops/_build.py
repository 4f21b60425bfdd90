"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` compiles, with the headers it includes, into one
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/`` at the root of the checkout (listed in
``.gitignore``) at first use; its name carries a hash of the sources, so an
edited kernel is never served from a stale library. The C entry points take
pointers and the stream as ``void*`` and return ``cudaGetLastError()``,
which :func:`check` turns into an exception.

Launch counts: each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNELS = ("rollout", "actor")

LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float

# argtypes of each C entry point, in order (see csrc/<name>.cu)
_SIGNATURES = {
    "rollout": ("rollout_launch", [
        _P, _P, _P, _P, _P, _P, _P, _P,   # cols pieces cursor lines moves status lg ml
        _P, _P, _I,                       # bank_cols bank_pieces bank
        _I, _I, _I,                       # n P n_steps
        _P, _P, _P, _U,                   # rots locs idxs seed
        _P,                               # tables
        _P, _P, _P, _P, _P, _P, _P,       # out state x6, out_stats
        _P,                               # stream
    ]),
    "actor": ("actor_launch", [
        _P, _P, _P, _P, _P, _P, _P, _P,   # cols pieces cursor lines moves status lg ml
        _P, _P, _I,                       # bank_cols bank_pieces bank
        _I, _I, _I, _I,                   # n P n_steps head
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # w1 b1 .. w5 b5
        _I, _F, _F, _F, _U,               # global_step eps_start eps_end eps_decay seed
        _P, _P, _P, _P,                   # explore_u rand_rot rand_col reset_idx
        _P,                               # tables
        _P, _P, _P, _P, _P, _P, _P,       # out state x6, out_stats
        _P, _P, _P, _P,                   # t_cols t_ncols t_int q_out
        _P,                               # stream
    ]),
}


def _sources(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu", CSRC / "env_step.cuh"]


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in _sources(name))
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU host")


def build(names=KERNELS) -> dict[str, Path]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Raises with nvcc's output on failure.
    nvcc's output, with ptxas's register and spill report, is kept in
    ``lib<name>-<hash>.log`` beside each library."""
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = out.with_suffix(".log").open("w")
        todo[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                      tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in todo.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text())
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def ptr(x) -> int | None:
    """A tensor's device address for ctypes (None for an absent input)."""
    return None if x is None else x.data_ptr()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
