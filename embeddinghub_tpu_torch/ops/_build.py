"""Build and load the CUDA kernels in ``embeddinghub_tpu_torch/csrc``.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds,
one process per source, all started together, and links the objects into
one shared library, loaded with :mod:`ctypes`.  The library goes to
``embeddinghub_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags: the first call after a change builds, every later call
in any process loads.  Nothing is taken from outside the checkout but the
CUDA toolkit itself.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes; every pointer and the stream are c_void_p so ctypes
# does not cut them to 32 bits.
_SIGNATURES = {
    "ehtorch_k1_tile": [_I] * 4,
    "ehtorch_fused_topk": [_P] * 10 + [_I] * 11 + [_P],
    "ehtorch_k2": [_P] * 13 + [_I] * 16 + [_P],
    "ehtorch_large_k_state_bytes": [_I],
    "ehtorch_large_k": [_P] * 10 + [_I] * 13 + [_P],
}
_RESTYPES = {"ehtorch_large_k_state_bytes": ctypes.c_longlong}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "embeddinghub_tpu_torch are built at first use and need the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):  # the headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libehtorch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build in a private directory, then rename: concurrent builds never
    # load a half-written library.
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        _run_all([[nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(_sources(), objs)])
        lib = Path(tmp) / "lib.so"
        _run_all([[nvcc, *_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]])
        os.replace(lib, out)
    return out


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the first failure's
    output once all have ended."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib
