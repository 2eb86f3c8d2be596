"""Build and load the port's CUDA kernels, and check what the wrappers
hand them.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an
object file — one ``nvcc`` process per source, all started together —
and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use, into
``build/kernels/`` at the repository root, keyed by a hash of the
sources, so a fresh checkout builds everything on its first kernel
launch and later processes reuse the library.

The library is built only where a kernel is launched, which needs a
CUDA card; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# head dims of the tensor-core (bfloat16) attention kernels
TC_HEAD_DIMS = (64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types; each returns cudaError_t
SIGNATURES = {
    "decode_attention_launch": [_I] + [_P] * 11 + [_I] * 8 + [_P],
    "chunk_attention_launch": [_P] * 10 + [_I] * 8 + [_P],
    "retention_attention_launch": [_P] * 5 + [_I] * 9 + [_P],
    "chunk_attention_tc_launch": [_P] * 9 + [_I] * 7 + [_P],
    "retention_attention_tc_launch": [_P] * 5 + [_I] * 9 + [_P],
    "capacity_loss_fwd_launch": [_P] * 4 + [_I] * 5 + [_F, _P],
    "capacity_loss_bwd_launch": [_P] * 4 + [_I] * 5 + [_F, _P],
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit's nvcc")
    return nvcc


def build() -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library's path. Compiler output, ptxas register and
    spill counts included, is kept in ``<digest>/nvcc.log``."""
    digest = source_digest()
    lib_path = BUILD_ROOT / f"libtrimkv_kernels_{digest}.so"
    if lib_path.exists():
        return lib_path
    work = BUILD_ROOT / digest
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in cus:
        obj = work / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (work / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = work / lib_path.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def build_log() -> str:
    """The compiler output of the current sources' build."""
    return (BUILD_ROOT / source_digest() / "nvcc.log").read_text()


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_tensor(name, x, shape, dtype, device):
    """Raise unless x has this device, dtype and shape and is
    contiguous: the kernels index raw pointers."""
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_device(x):
    """Raise unless x is a bfloat16 or float32 tensor on cuda:0."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if x.device.index not in (None, 0):
        raise ValueError("the kernels launch on cuda:0 only")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel dtype must be bfloat16 or float32, "
                        f"got {x.dtype}")


def check_aligned(**tensors):
    """Raise unless every tensor's base pointer is 16-byte aligned, as
    16-byte copies (cp.async, TMA) need."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel copies 16 bytes at a "
                             f"time and needs a 16-byte-aligned base")


def check_tc(D, **tensors):
    """Raise unless the tensor-core kernels take these (contiguous,
    already checked) tensors: a head dim of TC_HEAD_DIMS, and base
    pointers 16-byte aligned, as TMA needs."""
    if D not in TC_HEAD_DIMS:
        raise ValueError(f"the bfloat16 kernels take head dim "
                         f"{' or '.join(map(str, TC_HEAD_DIMS))}, got {D}")
    check_aligned(**tensors)


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t from a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
