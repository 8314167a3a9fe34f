"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use the sources are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per source
started together, and linked into one shared library with a plain C
interface, under ``vloam_tpu_torch/_build/`` and named by a hash of the
sources, the shared headers and the flags, so an edit rebuilds and an
unchanged tree reuses the library.  It is loaded with ``ctypes``; tensors pass as ``data_ptr()``
integers and kernels run on PyTorch's current stream.  Each C entry point
returns ``cudaGetLastError()`` after its launch and ``check`` raises on a
nonzero code.  Kernel attributes (dynamic shared memory above 48 KB) are set
once, by the ``vloam_*_setup`` functions that ``lib()`` calls when it loads
the library, never inside a launch or a graph capture.

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
SOURCES = ("knn_pair.cu", "knn.cu", "gn_lidar.cu", "gn_vo.cu", "gather_patches.cu",
           "gather_sweeps.cu", "gather_variants.cu")
HEADERS = ("knn_common.cuh", "gn_common.cuh", "gather_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# one k-NN problem up to its k: (q, q_stride, c, c_stride, mask, q_count, q_count_host,
# c_count, c_count_host, m, n, k)
_KNN_PROBLEM = [_P, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I]
_SIGNATURES = {
    # per problem (..., splits, pilot_step, pilot_splits, r2, d2, idx),
    # then (scratch, stats, stream)
    "vloam_knn_pair": (_KNN_PROBLEM + [_I, _I, _I, _F, _P, _P]) * 2 + [_P, _P, _P],
    # (..., splits, pilot_step, pilot_splits, d2, idx, scratch, stream)
    "vloam_knn": _KNN_PROBLEM + [_I, _I, _I, _P, _P, _P, _P],
    # (m, n, k, splits, pilot_step, pilot_splits) -> bytes, not an error code
    "vloam_knn_scratch_bytes": [_I, _I, _I, _I, _I, _I],
    # (pose0, stride, then each of ep, ea, eb, ev: pointer and row stride, be; the
    # same for pp, pn, pd, pv and bs; iters, huber_delta, lm_lambda, pose_out,
    # stream)
    "vloam_gn_lidar": [_P, _L] * 5 + [_I] + [_P, _L] * 4 + [_I, _I, _F, _F, _P, _P],
    # (pose0, stride, then X0, xb0, xb1, has_depth, no_depth: pointer and row
    # stride; m, iters, huber_delta, lm_lambda, pose_out, stream)
    "vloam_gn_vo": [_P, _L] * 6 + [_I, _I, _F, _F, _P, _P],
    "vloam_gn_lidar_setup": [],
    "vloam_gn_vo_setup": [],
    "vloam_sweeps_setup": [],
    "vloam_gather_variants_setup": [],
    "vloam_gather_patches": [_P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P],
    "vloam_gather_patches_stack": [_P, _I, _I, _I, _P, _I, _I, _P, _P],
    "vloam_whole_image": [_P, _I, _I, _P, _P],
    # () -> clusters resident at once, not an error code
    "vloam_whole_image_clusters": [],
    # (w) -> clusters of G3's launch resident at once, not an error code
    "vloam_sweep_batched_clusters": [_I],
    # (imgs, n_img, h_pad, w, flat): one tensor map's encoding, its CUresult
    "vloam_sweep_batched_encode": [_P, _I, _I, _I, _I],
}
# the strip sweeps: (imgs, n_img, h_pad, w, out, stream)
for _name in ("vloam_sweep_sync", "vloam_sweep_tma_ring", "vloam_sweep_batched",
              "vloam_sweep_batched_flat"):
    _SIGNATURES[_name] = [_P, _I, _I, _I, _P, _P]
# the gather formulations: (imgs, n_img, h_pad, w, meta, n2, out, stream)
for _name in ("vloam_gather_narrow", "vloam_gather_dma_only", "vloam_gather_compact_only",
              "vloam_gather_resident", "vloam_gather_mma", "vloam_gather_resident_mma"):
    _SIGNATURES[_name] = [_P, _I, _I, _I, _P, _I, _P, _P]
# run once each when the library is loaded
SETUPS = tuple(name for name in _SIGNATURES if name.endswith("_setup"))

_lib = None
_entries: dict = {}


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
            _entries[name] = fn
        for setup in SETUPS:
            check(_entries[setup](), setup)
        _lib = handle
    return _lib


def entry(name: str):
    """The bound C function ``name`` (loading the library at first use)."""
    if _lib is None:
        lib()
    return _entries[name]


def stream_ptr(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, also inside a
    graph capture, without building a Stream object."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel's inputs must all lie on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device, got {t.device}")
