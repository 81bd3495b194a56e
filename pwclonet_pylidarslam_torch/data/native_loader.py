"""ctypes bindings for the native scan loader + a prefetching batch pipeline.

The port's counterpart of ``pwclonet_pylidarslam_tpu/data/native_loader.py``.
The C++ side (``native/scanio.cpp``, read in place and unchanged) does the
per-file hot path — parallel file reads, format decode, fixed-count sampling
— with the GIL released; Python only orchestrates. :class:`Prefetcher`
overlaps host loading with device compute (the role of the reference's
``DataLoader(num_workers=…)``, trainer.py:557-574).

The library is built at first use, never at import: ``g++`` compiles
``native/scanio.cpp`` with the flags of ``native/Makefile`` into the port's
``build/`` directory (listed in ``.gitignore``), named by a hash of the
source and the flags as ``ops/_cuda.py`` names its kernels' library. The
tracked ``native/libscanio.so`` is neither loaded nor rebuilt.

Unlike the reference, a failed build is not hidden: the loaders raise with
the compiler's output, and nothing falls back to numpy on its own. The numpy
loop (the reference's fallback, the same sampling rule with numpy's
generator) is the plain version, reached only by ``backend="numpy"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pwclonet_pylidarslam_torch.data.other_datasets import nclt_decode_scan

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR.parent / "native" / "scanio.cpp"
BUILD_DIR = PACKAGE_DIR / "build"
# native/Makefile's CXXFLAGS and its -shared
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
BACKENDS = ("native", "numpy")

_lib = None
_lib_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + b"\0" + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libscanio_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/scanio.cpp`` unless this source's library is there;
    returns its path. Raises ``RuntimeError`` with the compiler's output."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise RuntimeError(f"cannot run {cmd[0]} to build {SOURCE.name}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders each write a whole file
    return path


def _load_library():
    """The loaded library; the first call builds it. A failure is kept and
    raised again on every later call."""
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise RuntimeError(_lib_error)
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as exc:
        _lib_error = f"the native scan loader is unavailable: {exc}"
        raise RuntimeError(_lib_error) from exc
    lib.scanio_load_bins.restype = ctypes.c_int64
    lib.scanio_load_bins.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_int64,
    ]
    lib.scanio_load_nclt.restype = ctypes.c_int64
    lib.scanio_load_nclt.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_uint64, ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the native library builds and loads here (the loaders raise
    where it does not)."""
    try:
        _load_library()
    except RuntimeError:
        return False
    return True


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")


def _c_paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def _sample(pts: np.ndarray, num_points: int, rng: np.random.Generator) -> np.ndarray:
    """The plain version's fixed-count sampling: a subsample without
    replacement, or every point and random repeats."""
    if len(pts) >= num_points:
        sel = rng.choice(len(pts), num_points, replace=False)
    else:
        sel = np.concatenate([np.arange(len(pts)), rng.choice(len(pts), num_points - len(pts))])
    return pts[sel]


def load_bins_batch(
    paths: Sequence[str],
    num_points: int,
    channels: int = 3,
    seed: int = 0,
    num_threads: int = 0,
    backend: str = "native",
) -> Tuple[np.ndarray, np.ndarray]:
    """Load KITTI ``.bin`` scans → ``(N, num_points, channels)`` float32 plus
    per-file raw counts (-1 where a file cannot be read). ``backend="native"``
    runs the C++ thread pool; ``"numpy"`` the plain loop."""
    _check_backend(backend)
    n = len(paths)
    out = np.zeros((n, num_points, channels), np.float32)
    counts = np.zeros((n,), np.int64)
    if backend == "native":
        _load_library().scanio_load_bins(
            _c_paths(paths), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_points,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            channels, seed, num_threads,
        )
        return out, counts
    rng = np.random.default_rng(seed)
    for i, p in enumerate(paths):
        try:
            pts = np.fromfile(p, dtype=np.float32).reshape(-1, 4)
        except (OSError, ValueError):
            counts[i] = -1
            continue
        counts[i] = len(pts)
        out[i] = _sample(pts, num_points, rng)[:, :channels]
    return out, counts


def load_nclt_batch(
    paths: Sequence[str],
    num_points: int,
    seed: int = 0,
    num_threads: int = 0,
    backend: str = "native",
) -> Tuple[np.ndarray, np.ndarray]:
    """Load NCLT packed scans → ``(N, num_points, 3)`` float32 + counts."""
    _check_backend(backend)
    n = len(paths)
    out = np.zeros((n, num_points, 3), np.float32)
    counts = np.zeros((n,), np.int64)
    if backend == "native":
        _load_library().scanio_load_nclt(
            _c_paths(paths), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_points,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            seed, num_threads,
        )
        return out, counts
    rng = np.random.default_rng(seed)
    for i, p in enumerate(paths):
        pts = nclt_decode_scan(np.fromfile(p, dtype=np.uint16))
        counts[i] = len(pts)
        out[i] = _sample(pts, num_points, rng)
    return out, counts


class Prefetcher:
    """Background-thread batch prefetcher (host→device overlap).

    Wraps any batch iterator factory; keeps up to ``depth`` ready batches.
    """

    def __init__(self, batches_fn: Callable[[], Iterator], depth: int = 2):
        self.batches_fn = batches_fn
        self.depth = depth

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        error: List[BaseException] = []

        def producer():
            try:
                for batch in self.batches_fn():
                    q.put(batch)
            except BaseException as exc:  # noqa: BLE001 — re-raised on consumer side
                error.append(exc)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
