"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use the sources are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per source
started together, and linked into one shared library with a plain C
interface, under ``vloam_tpu_torch/_build/`` and named by a hash of the
sources, the shared headers and the flags, so an edit rebuilds and an
unchanged tree reuses the library.  It is loaded with ``ctypes``; tensors pass as ``data_ptr()``
integers and kernels run on PyTorch's current stream.  Each C entry point
returns ``cudaGetLastError()`` after its launch and ``check`` raises on a
nonzero code.

Nothing here runs at import: the CPU test suite imports every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("knn_pair.cu", "knn.cu", "gn_lidar.cu", "gn_vo.cu", "gather_patches.cu")
HEADERS = ("knn_common.cuh", "gn_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "vloam_knn_pair": (
        [_P, _P, _P, _P, _I, _I, _I, _P, _P] * 2 + [_P, _P]
    ),
    "vloam_knn": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "vloam_gn_lidar": [_P, _P, _I, _P, _I, _I, _F, _F, _P, _P],
    "vloam_gn_vo": [_P, _P, _I, _I, _F, _F, _P, _P],
    "vloam_gather_patches": [_P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P],
}

_lib = None


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libvloam_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these exact sources exists:
    one ``nvcc -c`` per source, all running at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [os.path.join(tmp_dir, Path(s).stem + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
                 "-o", obj, str(SRC_DIR / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(src, proc.returncode, log)
                  for src, proc, log in zip(SOURCES, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{src} ({rc}):\n{log}" for src, rc, log in failed))
        if verbose:
            print("".join(logs))
        tmp_so = os.path.join(tmp_dir, out.name)
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_so, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp_so, out)  # atomic: a concurrent build never sees half a file
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel's inputs must all lie on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device, got {t.device}")
