"""ctypes binding of the C++ host library (port of ``vloam_tpu/runtime/native.py``).

The library is built from two sources.  ``native/vloam_host.cpp``: the
``.bin`` and PNG loaders, the ring gridding, the less-flat voxel table, the
depth buckets and an ordered prefetcher whose worker threads read, decode
and grid frames ahead of the device (the role rosbag replay played in the
reference, vloam_main_node.cpp:226-232).  That source lies outside the JAX
package and includes nothing of it, so the port binds it where it is
instead of keeping a second copy; it is never edited here.  The port's own
``csrc/host_grid.cpp``: the ring gridding that ``VloamDriver.process``
runs, in float32 and threaded over the cloud (``grid_cloud_threaded``).

At first use both are compiled with ``g++ -O2 -fPIC -shared -std=c++17
-ffp-contract=off ... -lpng -lpthread`` into ``vloam_tpu_torch/_build/``
(git-ignored), named by a hash of the sources and the flags, through a
per-process temporary name and ``os.replace``, so concurrent first uses
(test workers) do not collide.  No contraction into fused multiply-adds, so
the gridding rounds each float32 operation as NumPy does on every host.
Nothing is written under ``native/``, and the library that the JAX binding
builds there is never loaded.

libpng comes in one of two ways (``png_route``): the system's headers and
``-lpng``; or, on a machine with no ``png.h`` (a container without the
libpng development package), the port's declarations of the libpng 1.6
calls the source makes (``vloam_tpu_torch/native_png/png.h``) linked
against the libpng16 runtime that Pillow ships in ``pillow.libs``.

``available()`` is False when neither way exists, ``g++`` is missing or the
build fails; the driver then runs the NumPy host path (``data/gridding``,
``data/kitti``), the same contract as the reference binding.  ``build()``
raises instead, for callers that must not fall back.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "vloam_host.cpp"
GRID_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_grid.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
PNG_DECL_DIR = Path(__file__).resolve().parents[1] / "native_png"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

_FP = ctypes.POINTER(ctypes.c_float)
_UP = ctypes.POINTER(ctypes.c_ubyte)
_IP = ctypes.POINTER(ctypes.c_int)
_I, _F, _S, _V = ctypes.c_int, ctypes.c_float, ctypes.c_char_p, ctypes.c_void_p
_SIGNATURES = {   # name: (restype, argtypes)
    "vh_load_bin": (_I, [_S, _FP, _I]),
    "vh_load_png_gray": (_I, [_S, _FP, _I, _I]),
    "vh_prefetcher_create": (_V, [_S, _S, _I, _I, _I, _I, _I, _I, _I, _F, _F]),
    "vh_prefetcher_next": (_I, [_V, _FP, _FP]),
    "vh_prefetcher_next_grid": (_I, [_V, _FP, _UP, _IP, _FP]),
    "vh_grid_cloud": (_I, [_FP, _I, _I, _I, _I, _F, _F, _FP, _UP, _IP]),
    "vh_grid_cloud_threaded": (_I, [_FP, _I, _I, _I, _I, _F, _F, _I, _FP, _UP, _IP]),
    "vh_lf_voxel_table": (_I, [_FP, _UP, _I, _I, _F, _I, _I, _IP, _FP]),
    "vh_depth_buckets": (_I, [_FP, _UP, _I, _I, _FP, _I, _I, _I, _F, _FP, _FP, _FP, _FP]),
    "vh_prefetcher_len": (_I, [_V]),
    "vh_prefetcher_destroy": (None, [_V]),
}

_lib = None   # the loaded library, False once loading failed


def _system_png_h(gxx: str) -> bool:
    probe = subprocess.run([gxx, "-E", "-x", "c++", "-include", "png.h", "-o", os.devnull,
                            os.devnull], capture_output=True)
    return probe.returncode == 0


def _pillow_libpng() -> Path | None:
    """The libpng16 runtime Pillow ships beside its package (found without
    importing PIL), or None."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    libs = Path(next(iter(spec.submodule_search_locations))).parent / "pillow.libs"
    found = sorted(libs.glob("libpng16*.so*"))
    return found[0] if found else None


def png_route() -> tuple[tuple[str, ...], str] | None:
    """How libpng enters the build: (g++ arguments, a description), or None
    when there is no ``g++`` or no libpng to build with."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    if _system_png_h(gxx):
        return ("-lpng",), "the system's libpng headers, -lpng"
    lib = _pillow_libpng()
    if lib is None:
        return None
    return (("-I", str(PNG_DECL_DIR), str(lib), f"-Wl,-rpath,{lib.parent}"),
            f"no png.h on this machine: {PNG_DECL_DIR.name}/png.h against {lib}")


def toolchain_missing() -> str | None:
    """Why the library cannot be built here, or None when it can."""
    for src in (SOURCE, GRID_SOURCE):
        if not src.exists():
            return f"{src} not found"
    if shutil.which("g++") is None:
        return "g++ not found"
    if png_route() is None:
        return "png.h not found and no libpng16 runtime beside Pillow"
    return None


def library_path(route=None) -> Path:
    route = route or png_route()
    h = hashlib.sha256(" ".join(CXX_FLAGS + (route[0] if route else ())).encode())
    for src in (SOURCE, GRID_SOURCE):
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvloam_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists for this source and libpng
    route; raises RuntimeError with the compiler's output when it cannot
    be built."""
    missing = toolchain_missing()
    if missing:
        raise RuntimeError(f"cannot build the native host library: {missing}")
    route = png_route()
    out = library_path(route)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.stem}.{os.getpid()}.so"
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), str(GRID_SOURCE),
                              *route[0], "-lpthread"], capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load():
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.TimeoutExpired):
            _lib = False
        else:
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib or None


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def load_bin(path: str, max_points: int) -> tuple[np.ndarray, int]:
    """Velodyne .bin -> ((max_points, 3) xyz zero-padded, point count)."""
    out = np.zeros((max_points, 3), np.float32)
    n = _load().vh_load_bin(path.encode(), _ptr(out, _FP), max_points)
    if n < 0:
        raise IOError(f"vh_load_bin failed for {path}")
    return out, n


def grid_cloud_native(pts: np.ndarray, cfg) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """C++ twin of ``data/gridding.grid_cloud`` (same semantics, same outputs)."""
    pts = np.ascontiguousarray(pts, np.float32)
    R, C = cfg.n_scans, cfg.ring_cap
    grid = np.zeros((R, C, 4), np.float32)
    mask = np.zeros((R, C), np.uint8)
    npr = np.zeros((R,), np.int32)
    rc = _load().vh_grid_cloud(_ptr(pts, _FP), pts.shape[0], pts.shape[1], R, C,
                               cfg.minimum_range, cfg.scan_period, _ptr(grid, _FP),
                               _ptr(mask, _UP), _ptr(npr, _IP))
    if rc < 0:
        raise ValueError(f"vh_grid_cloud failed rc={rc}")
    return grid, mask.astype(bool), npr


def grid_cloud_threaded(pts: np.ndarray, cfg) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``data/gridding.grid_cloud`` in the port's threaded C++ gridder: the
    same masks, counts and points, w within float32 rounding.  Every output
    is a fresh array, written whole by the library."""
    return _grid_cloud_threads(pts, cfg, 0)


def _grid_cloud_threads(pts: np.ndarray, cfg, n_threads: int
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``grid_cloud_threaded`` on ``n_threads`` threads (0: as many as the
    library chooses from the CPUs and the cloud's size)."""
    pts = np.ascontiguousarray(pts, np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"a cloud is (N, 3) or (N, 4), got {pts.shape}")
    R, C = cfg.n_scans, cfg.ring_cap
    grid = np.empty((R, C, 4), np.float32)
    mask = np.empty((R, C), np.bool_)
    npr = np.empty((R,), np.int32)
    rc = _load().vh_grid_cloud_threaded(_ptr(pts, _FP), pts.shape[0], pts.shape[1], R, C,
                                        cfg.minimum_range, cfg.scan_period, n_threads,
                                        _ptr(grid, _FP), _ptr(mask, _UP), _ptr(npr, _IP))
    if rc < 0:
        raise ValueError(f"vh_grid_cloud_threaded failed rc={rc}")
    return grid, mask, npr


def depth_buckets_native(pts: np.ndarray, mask: np.ndarray | None, proj: np.ndarray, vc
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """C++ twin of ``data/gridding.depth_buckets`` (same outputs)."""
    pts = np.ascontiguousarray(pts, np.float32)
    proj = np.ascontiguousarray(proj, np.float32)
    g = vc.downsample_grid
    bw, bh = -(-vc.img_width // g), -(-vc.img_height // g)
    u, v, z, c = (np.zeros((bw, bh), np.float32) for _ in range(4))
    mask8 = None if mask is None else np.ascontiguousarray(mask, np.uint8)  # kept past the call
    rc = _load().vh_depth_buckets(
        _ptr(pts, _FP), None if mask8 is None else _ptr(mask8, _UP), pts.shape[0], pts.shape[1],
        _ptr(proj, _FP), g, bw, bh, vc.min_projection_depth,
        _ptr(u, _FP), _ptr(v, _FP), _ptr(z, _FP), _ptr(c, _FP))
    if rc < 0:
        raise ValueError(f"vh_depth_buckets failed rc={rc}")
    return u, v, z, c


def lf_voxel_table_native(grid: np.ndarray, gmask: np.ndarray, cfg, max_grid: int = 1024
                          ) -> tuple[np.ndarray, np.ndarray, int]:
    """C++ twin of ``data/gridding.less_flat_voxel_table`` (same outputs)."""
    R, C = gmask.shape
    flat = np.ascontiguousarray(grid.reshape(-1, 4), np.float32)
    m8 = np.ascontiguousarray(gmask.reshape(-1), np.uint8)
    slot = np.zeros((R * C,), np.int32)
    base = np.zeros((cfg.less_flat_cap, 5), np.float32)
    n_runs = _load().vh_lf_voxel_table(_ptr(flat, _FP), _ptr(m8, _UP), R, C, cfg.less_flat_voxel,
                                       cfg.less_flat_cap, max_grid, _ptr(slot, _IP),
                                       _ptr(base, _FP))
    if n_runs < 0:
        raise ValueError(f"vh_lf_voxel_table failed rc={n_runs}")
    return slot.reshape(R, C), base, n_runs


def load_png_gray(path: str, height: int, width: int) -> np.ndarray:
    """8-bit grayscale PNG -> (height, width) float32, zero-padded or cropped."""
    out = np.zeros((height, width), np.float32)
    rc = _load().vh_load_png_gray(path.encode(), _ptr(out, _FP), height, width)
    if rc != 0:
        raise IOError(f"vh_load_png_gray failed ({rc}) for {path}")
    return out


class NativePrefetcher:
    """Ordered asynchronous frame stream over .bin (and PNG) paths, read and
    decoded by ``n_threads`` worker threads up to ``depth`` frames ahead.

    Iterating yields (cloud (max_points, 3), n_points, image or None);
    ``iter_grids`` yields ring grids instead (needs ``scan_cfg``).  Close
    it (``close()``, or use it as a context manager): that joins the
    worker threads."""

    def __init__(self, bin_paths: list[str], img_paths: list[str] | None, max_points: int,
                 height: int = 0, width: int = 0, depth: int = 3, n_threads: int = 2,
                 scan_cfg=None):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native host library is not available (g++ and libpng)")
        self._lib = lib
        self.max_points = max_points
        self.height, self.width = height, width
        self.with_images = img_paths is not None
        self.scan_cfg = scan_cfg
        imgs = "\n".join(img_paths) if img_paths is not None else ""
        sc = scan_cfg
        self._h = lib.vh_prefetcher_create(
            "\n".join(bin_paths).encode(), imgs.encode(), max_points, height, width, depth,
            n_threads, sc.n_scans if sc else 0, sc.ring_cap if sc else 0,
            sc.minimum_range if sc else 0.0, sc.scan_period if sc else 0.1)
        self._len = lib.vh_prefetcher_len(self._h)

    def __len__(self):
        return self._len

    def _check_open(self):
        if not self._h:
            raise ValueError("the prefetcher is closed")

    def _image_buffer(self):
        return np.zeros((self.height, self.width), np.float32) if self.with_images else None

    def __iter__(self):
        cloud = np.zeros((self.max_points, 3), np.float32)
        img = self._image_buffer()
        for _ in range(self._len):
            self._check_open()
            rc = self._lib.vh_prefetcher_next(self._h, _ptr(cloud, _FP),
                                              None if img is None else _ptr(img, _FP))
            if rc < 0:
                raise IOError(f"prefetcher frame failed rc={rc}")
            yield cloud.copy(), rc, (None if img is None else img.copy())

    def iter_grids(self):
        """Grid-mode stream: yields (grid (R, C, 4), gmask (R, C), n_per_ring,
        image or None); the ring gridding ran in the worker threads."""
        if self.scan_cfg is None:
            raise ValueError("iter_grids needs a prefetcher created with scan_cfg")
        R, C = self.scan_cfg.n_scans, self.scan_cfg.ring_cap
        grid = np.zeros((R, C, 4), np.float32)
        mask = np.zeros((R, C), np.uint8)
        npr = np.zeros((R,), np.int32)
        img = self._image_buffer()
        for _ in range(self._len):
            self._check_open()
            rc = self._lib.vh_prefetcher_next_grid(self._h, _ptr(grid, _FP), _ptr(mask, _UP),
                                                   _ptr(npr, _IP),
                                                   None if img is None else _ptr(img, _FP))
            if rc < 0:
                raise IOError(f"prefetcher frame failed rc={rc}")
            yield (grid.copy(), mask.astype(bool), npr.copy(),
                   None if img is None else img.copy())

    def close(self):
        if self._h:
            self._lib.vh_prefetcher_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
