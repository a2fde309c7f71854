"""Build and load the hand-written Hopper kernels of ``csrc/``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface, loaded with :mod:`ctypes`. The build happens at the first call of
:func:`library`, into ``audiogpt_tpu_torch/_build/``; the library's name
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing here runs at import time: the CPU tests
import every module on a machine that has no ``nvcc``. The link needs no
``-lcuda``: both flash kernels fetch the driver's
``cuTensorMapEncodeTiled`` (their TMA descriptors) through the runtime's
``cudaGetDriverEntryPoint`` (``csrc/sm90.cuh``). A ``*.cuh`` header is
hashed with the sources.

The kernels may launch from several threads of one process (one per card,
or several streams of one card: ``engines/base.py`` ``ReplicaRunner``), so
the first load is guarded by a lock, and the wrappers update their launch
counters under :data:`COUNT_LOCK`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C entry points: name → argument types (every entry returns cudaError_t)
SIGNATURES = {
    # q, k, v, kv_mask (nullable), out, B, Tq, Tk, H, D, scale, causal, stream
    "flash_attention_f32": (_VOID_P,) * 5 + (_INT,) * 5 + (_FLOAT, _INT,
                                                           _VOID_P),
    "flash_attention_bf16": (_VOID_P,) * 5 + (_INT,) * 5 + (_FLOAT, _INT,
                                                            _VOID_P),
    # B, Tq, H, D, &rows_per_block, &blocks_per_sm (the f32 kernel; the
    # bf16 kernel's)
    "flash_attention_occupancy": (_INT,) * 4
    + (ctypes.POINTER(ctypes.c_int),) * 2,
    "flash_attention_bf16_occupancy": (_INT,) * 4
    + (ctypes.POINTER(ctypes.c_int),) * 2,
    # x, alpha, beta, out, B, C, T, stream
    "snake_aa_f32": (_VOID_P,) * 4 + (_INT,) * 3 + (_VOID_P,),
    "snake_aa_bf16": (_VOID_P,) * 4 + (_INT,) * 3 + (_VOID_P,),
}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or the ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libaudiogpt_kernels_<hash>.so``
    (skipped when that file exists). ptxas' report of registers, shared
    memory and spills is kept in ``_build/build.log``."""
    BUILD_DIR.mkdir(exist_ok=True)
    lib = BUILD_DIR / f"libaudiogpt_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        (BUILD_DIR / "build.log").write_text("\n".join(logs))
        failed = [(s.name, log) for s, p, log in zip(sources(), procs, logs)
                  if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs,
                               "-o", str(tmp_lib)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        os.replace(tmp_lib, lib)
    return lib


_LOAD_LOCK = threading.Lock()
_LIBRARY: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Two threads' first
    calls build and load it once: the second waits for the first."""
    global _LIBRARY
    if _LIBRARY is None:
        with _LOAD_LOCK:
            if _LIBRARY is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _LIBRARY = lib
    return _LIBRARY


#: guards every wrapper's launch counters: ``+=`` on an attribute is not
#: atomic between threads
COUNT_LOCK = threading.Lock()


def count_launch(wrapper, device: int, stream: int, bf16: bool,
                 flops: int = 0) -> None:
    """Count one launch of ``wrapper``'s kernel in its totals (``launches``,
    ``bf16_launches`` and, given, ``flops``), on its card
    (``launches_by_device``, by device index) and on its stream
    (``launches_by_stream``, by (device index, stream handle): the replicas
    of one card run on streams of their own)."""
    with COUNT_LOCK:
        wrapper.launches += 1
        wrapper.bf16_launches += bf16
        if flops:
            wrapper.flops += flops
        wrapper.launches_by_device[device] += 1
        wrapper.launches_by_stream[(device, stream)] += 1


def reset_counts(wrapper) -> None:
    """Set every launch counter of ``wrapper`` to 0."""
    with COUNT_LOCK:
        wrapper.launches = wrapper.bf16_launches = 0
        wrapper.launches_by_device = Counter()
        wrapper.launches_by_stream = Counter()


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch)."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
