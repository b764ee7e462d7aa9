"""Build and load the port's CUDA kernels.

Each source in ``apex_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and
loaded with ``ctypes``.  The build happens at first use, never at
import: every ``nvcc`` is started at once and all are awaited, so the
build takes as long as the slowest source.  ``--split-compile=0`` lets
each ``nvcc`` optimise its source's kernels on every core (the wgmma
variants of ``flash_attention.cu`` are the long pole).  The libraries
land in ``build/apex_tpu_torch/`` beside the package, named by a hash of
their source and the shared headers (``csrc/*.cuh``), so an edited
source is rebuilt and an unchanged one is reused.  A failed build raises
with the compiler's output.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.  The wrappers
count their launches in :data:`launches`, keyed by kernel entry (one
library may hold several kernels) — one per kernel launch, and nowhere
else — so a run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = ["SOURCES", "ENTRIES", "FLOAT_CODES", "DTYPE_CODES", "build_dir", "build_all",
           "function", "check", "launches", "reset_launches"]

_PKG = Path(__file__).resolve().parent
#: kernel library name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "layer_norm": "layer_norm.cu",
    "rope": "rope.cu",
    "fused_sampling": "fused_sampling.cu",
    "flash_attention": "flash_attention.cu",
    "paged_attention": "paged_attention.cu",
    "batch_norm": "batch_norm.cu",
    "fp8_adam": "fp8_adam.cu",
    "softmax": "softmax.cu",
    "group_norm": "group_norm.cu",
}
#: kernel entries, the keys of :data:`launches` (each lives in the
#: library of SOURCES its name begins with; ``bn_*`` in batch_norm)
ENTRIES = ("layer_norm", "layer_norm_bwd", "rope", "fused_sampling",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "paged_attention",
           "paged_decode_fused", "bn_reduce", "bn_apply", "bn_bwd_reduce",
           "bn_bwd_dx", "fp8_adam", "softmax_fwd", "softmax_bwd",
           "group_norm_fwd", "group_norm_bwd", "group_norm_fwd_3pass",
           "group_norm_bwd_3pass")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "--split-compile=0", "-Xcompiler", "-fPIC")

#: dtype codes of the floating types every kernel computes in
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: dtype codes shared by every C entry point (csrc/common.cuh): the float
#: types, and the 1-byte codes of a quantized paged KV pool
DTYPE_CODES = {**FLOAT_CODES, torch.int8: 3, torch.float8_e4m3fn: 4}

#: launches per kernel entry since the last :func:`reset_launches`
launches: Dict[str, int] = {name: 0 for name in ENTRIES}

_lock = threading.Lock()
_paths: Dict[str, Path] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build_dir() -> Path:
    return _PKG.parent / "build" / "apex_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_all(ptxas_info: bool = False) -> Dict[str, str]:
    """Compile every kernel library that is not built yet, all ``nvcc``
    processes in parallel.  Returns ``{name: compiler output}`` for the
    sources compiled in this call (with ``ptxas_info``, ``-Xptxas -v``
    adds each kernel's registers, shared memory and spills)."""
    with _lock:
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = {}
        for name, src in SOURCES.items():
            if name in _paths:
                continue
            path = _PKG / "csrc" / src
            # the shared headers are part of every library's source
            digest = hashlib.sha256(path.read_bytes() + b"".join(
                h.read_bytes() for h in sorted((_PKG / "csrc").glob(
                    "*.cuh")))).hexdigest()[:16]
            lib = out_dir / f"lib{name}-{digest}.so"
            if lib.exists() and not ptxas_info:
                _paths[name] = lib
            else:
                todo[name] = (path, lib)
        if not todo:
            return {}
        nvcc = _nvcc()
        procs = {}
        for name, (src, lib) in todo.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            if ptxas_info:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        logs, failed = {}, []
        for name, (proc, tmp, lib) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
                continue
            os.replace(tmp, lib)
            _paths[name] = lib
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(logs[n] for n in failed))
        return logs


def function(lib_name: str, symbol: str, argtypes) -> object:
    """The C entry ``symbol`` of kernel library ``lib_name``, with its
    ``argtypes`` declared and an ``int`` (CUDA error code) result;
    builds the libraries at first use."""
    key = (lib_name, symbol)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    if lib_name not in _paths:
        build_all()
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            lib = ctypes.CDLL(str(_paths[lib_name]))
            _libs[lib_name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(code: int, name: str) -> None:
    """Raise if the launch of kernel ``name`` returned a CUDA error;
    count the launch otherwise."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
    launches[name] += 1
