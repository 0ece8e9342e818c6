"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface
(sources may share a ``csrc/*.cuh`` header).  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``) and loaded with ``ctypes``.  The library's file name
carries a hash of its source, the headers and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  :func:`build` starts one ``nvcc`` per
source, all at once, so building every kernel costs the slowest one.

Nothing here runs at import time: the CPU tests import every module of
the port, so this module must import where there is no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.POINTER(ctypes.c_longlong)     # a host array of int64 strides

#: The C entry points of every kernel source, with their argument types
#: (pointers and the stream as ``c_void_p``: ctypes would cut them to 32
#: bits otherwise).  Each returns ``cudaGetLastError()`` as an int.
SIGNATURES = {
    "linear_scan": {
        "linear_scan_f32": [_P] * 4 + [_I] * 3 + [_P],
        "linear_scan_bf16": [_P] * 4 + [_I] * 3 + [_P],
    },
    "linear_scan_bwd": {
        "linear_scan_bwd_f32": [_P] * 7 + [_I] * 3 + [_P],
        "linear_scan_bwd_bf16": [_P] * 7 + [_I] * 3 + [_P],
    },
    "minimalist_step": {
        "minimalist_step_f32": [_P, _P, _P, _F] + [_P] * 6 + [_I] * 3 + [_P],
    },
    "minimalist_block": {
        "minimalist_block_f32": [_P, _P, _P, _F] + [_P] * 5 + [_I] * 5
        + [_P],
    },
    "paged_gqa": {
        "paged_gqa_f32": [_P] * 6 + [_I] * 9 + [_P],
        "paged_gqa_bf16": [_P] * 6 + [_I] * 9 + [_P],
        "paged_gqa_layout": [_I] * 4 + [_P],
    },
    "paged_gqa_q8": {
        "paged_gqa_q8_f32": [_P] * 8 + [_I] * 9 + [_P],
        "paged_gqa_q8_bf16": [_P] * 8 + [_I] * 9 + [_P],
        "paged_gqa_q8_layout": [_I] * 3 + [_P],
    },
    "flash_fwd": {
        "flash_fwd_f32": [_P] * 5 + [_L] + [_I] * 7 + [_P],
        "flash_fwd_bf16": [_P] * 5 + [_L] + [_I] * 7 + [_P],
        "flash_fwd_bf16_tc": [_P] * 5 + [_L] + [_I] * 7 + [_P],
    },
    "flash_bwd": {
        "flash_bwd_dq_f32": [_P] * 10 + [_L] + [_I] * 7 + [_P],
        "flash_bwd_dq_bf16": [_P] * 10 + [_L] + [_I] * 7 + [_P],
        "flash_bwd_dkv_f32": [_P] * 10 + [_L] + [_I] * 7 + [_P],
        "flash_bwd_dkv_bf16": [_P] * 10 + [_L] + [_I] * 7 + [_P],
        "flash_bwd_dq_bf16_tc": [_P] * 10 + [_L] + [_I] * 7 + [_P],
        "flash_bwd_dkv_bf16_tc": [_P] * 10 + [_L] + [_I] * 7 + [_P],
    },
    "fused_ssm_fwd": {
        "fused_ssm_fwd_f32": [_P] * 9 + [_I] * 5 + [_P],
        "fused_ssm_fwd_info": [_I, _P],
    },
    "fused_ssm_bwd": {
        "fused_ssm_bwd_f32": [_P] * 12 + [_I] * 6 + [_P],
        "fused_ssm_bwd_info": [_I, _P],
    },
    "paged_mla": {
        "paged_mla_f32": [_P] * 9 + [_I] * 10 + [_F, _P],
        "paged_mla_bf16": [_P] * 9 + [_I] * 10 + [_F, _P],
        "paged_mla_bf16_tc": [_P] * 9 + [_I] * 9 + [_F, _P],
        "paged_mla_tc_info": [_P],
    },
    "paged_mla_q8": {
        "paged_mla_q8_f32": [_P] * 11 + [_I] * 10 + [_F, _P],
        "paged_mla_q8_bf16": [_P] * 11 + [_I] * 10 + [_F, _P],
        "paged_mla_q8_bf16_tc": [_P] * 11 + [_I] * 9 + [_F, _P],
        "paged_mla_q8_tc_info": [_P],
    },
    "imc_mvm": {
        "imc_mvm_f32": [_P] * 4 + [_I] * 3 + [_P],
        "imc_mvm_f32_tc": [_P] * 4 + [_I] * 3 + [_P],
    },
}

#: Every kernel of the port, by source stem.
KERNELS = tuple(SIGNATURES)

_LOADED: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the
    toolkit's default location, else whatever ``PATH`` finds."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=KERNELS, *, ptxas_verbose: bool = False) -> dict:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: compiler output}`` for the kernels it compiled (register and
    spill counts when ``ptxas_verbose``); raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, out)       # atomic: readers never see half a .so
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error (its return value is
    ``cudaGetLastError()`` right after the launch)."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
