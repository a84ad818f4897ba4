"""ctypes bindings for the native C++ radar PNG decoder and its decode pool.

Counterpart of `radarslampy_tpu/io/native_loader.py`, over the port's own copy
of the source (`io/native/radar_loader.cpp`):

  * `decode_radar_png_native(path, cfg, raw_u8=False)`: one PNG, as
    `io/oxford.decode_radar_png` decodes it;
  * `NativeLoader(paths, cfg, workers=4, depth=8, raw_u8=False)`: a pool of
    C++ threads that decode ahead (libpng, no Python lock held) and deliver
    the frames in order, at most `depth` frames ahead of the consumer.

Frames come back as the port's `io/oxford.RadarFrame`.  Properties of the C++
decoder, kept as they are: the azimuth is `ticks / 5600 * 2 pi` whatever
`cfg.encoder_size` says; an RGB PNG goes through libpng's rgb_to_gray (the
PIL path takes channel 0); the float path multiplies by `1/255` (PIL divides).

Build: `g++ -O2 -shared -fPIC <source> -lpng` at first use, into
`radarslampy_tpu_torch/_build/libradar_loader-<hash>.so`, named by a hash of
the source and the flags, through a temporary file and `os.replace`, so
processes that build at once leave one complete library.  g++'s output is
kept beside it as `.log`.  `native_available()` says whether the library
built and loaded; without g++ or libpng the driver decodes with PIL instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.io.oxford import RadarFrame

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "io" / "native" / "radar_loader.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]
LIBS = ["-lpng"]
RAW_COLS = 11 + 3768  # Oxford PNG layout: metadata + power bins

build_log = ""      # g++'s output of this process's build, or why the library is missing
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False

_P_U8 = ctypes.POINTER(ctypes.c_uint8)
_P_F32 = ctypes.POINTER(ctypes.c_float)
_P_I64 = ctypes.POINTER(ctypes.c_int64)
_GEOMETRY = [ctypes.c_int] * 4   # num_azimuths, raw_cols, clip_bins, padded_bins


def _write_atomic(path: Path, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile `SOURCE` into `build_dir`, once per hash of the source and the
    flags; return the .so.  Raises RuntimeError when g++ is missing or fails
    (a missing `png.h` or libpng among the causes); the log says which."""
    global build_log
    build_dir = Path(build_dir)
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    lib_path = build_dir / f"libradar_loader-{digest}.so"
    if lib_path.exists():
        return lib_path
    gxx = shutil.which("g++")
    if gxx is None:
        build_log = "g++ not found on PATH"
        raise RuntimeError(build_log)
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=build_dir, prefix=lib_path.name, suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), *LIBS, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        build_log = proc.stdout + proc.stderr
        _write_atomic(lib_path.with_suffix(".log"), build_log.encode())
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name, power in (("rsl_decode", _P_F32), ("rsl_decode_u8", _P_U8)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, *_GEOMETRY, power, _P_F32, _P_U8, _P_I64]
        fn.restype = ctypes.c_int
    lib.rsl_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, *_GEOMETRY]
    lib.rsl_loader_create.restype = ctypes.c_void_p
    for name, power in (("rsl_loader_next", _P_F32), ("rsl_loader_next_u8", _P_U8)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, power, _P_F32, _P_U8, _P_I64]
        fn.restype = ctypes.c_int
    lib.rsl_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.rsl_loader_destroy.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None (and `build_log` says
    why) when it cannot be built or loaded.  A failure is not retried."""
    global _lib, _failed, build_log
    with _lock:
        if _lib is None and not _failed:
            try:
                _lib = _declare(ctypes.CDLL(str(build_library())))
            except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
                build_log = str(exc)
                _failed = True
        return _lib


def native_available() -> bool:
    return _load() is not None


def _alloc(cfg: SlamConfig, raw_u8: bool):
    A = cfg.num_azimuths
    return (np.zeros((A, cfg.polar_width_padded), np.uint8 if raw_u8 else np.float32),
            np.zeros(A, np.float32), np.zeros(A, np.uint8), np.zeros(A, np.int64))


def _ptrs(power, az, valid, ts):
    return (power.ctypes.data_as(_P_U8 if power.dtype == np.uint8 else _P_F32),
            az.ctypes.data_as(_P_F32), valid.ctypes.data_as(_P_U8),
            ts.ctypes.data_as(_P_I64))


def _geometry(cfg: SlamConfig):
    if not 0 < cfg.clipped_range_bins <= min(RAW_COLS - 11, cfg.polar_width_padded):
        raise ValueError(f"clipped_range_bins {cfg.clipped_range_bins} outside the PNG's "
                         f"{RAW_COLS - 11} bins or the padded width {cfg.polar_width_padded}")
    return cfg.num_azimuths, RAW_COLS, cfg.clipped_range_bins, cfg.polar_width_padded


def _stamp(path: str) -> int:
    return int(os.path.basename(path)[:-4])


def decode_radar_png_native(path: str, cfg: SlamConfig, raw_u8: bool = False) -> RadarFrame:
    """One Oxford PNG through the C++ decoder.  `raw_u8=True` keeps power as
    the raw PNG bytes, dequantised on the device by the step."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {build_log}")
    power, az, valid, ts = _alloc(cfg, raw_u8)
    fn = lib.rsl_decode_u8 if raw_u8 else lib.rsl_decode
    rc = fn(os.fsencode(path), *_geometry(cfg), *_ptrs(power, az, valid, ts))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return RadarFrame(power, az, valid.astype(bool), ts, _stamp(path))


class NativeLoader:
    """In-order iterator over `paths`, decoded ahead by a pool of `workers`
    C++ threads.  A frame that fails to decode raises IOError when it is
    reached.  The pool stops at the end of the iteration or on `close()`."""

    def __init__(self, paths: List[str], cfg: SlamConfig, workers: int = 4,
                 depth: int = 8, raw_u8: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {build_log}")
        self._lib = lib
        self._cfg = cfg
        self._raw_u8 = raw_u8
        self._stamps = [_stamp(p) for p in paths]
        # the C++ pool keeps its own copies of the path strings
        arr = (ctypes.c_char_p * len(paths))(*(os.fsencode(p) for p in paths))
        self._handle = lib.rsl_loader_create(arr, len(paths), workers, depth,
                                             *_geometry(cfg))

    def __iter__(self) -> Iterator[RadarFrame]:
        next_fn = self._lib.rsl_loader_next_u8 if self._raw_u8 else self._lib.rsl_loader_next
        try:
            for i, stamp in enumerate(self._stamps):
                if not self._handle:
                    return
                power, az, valid, ts = _alloc(self._cfg, self._raw_u8)
                rc = next_fn(self._handle, *_ptrs(power, az, valid, ts))
                if rc == -2:
                    return
                if rc != 0:
                    raise IOError(f"native decode failed at frame {i}")
                yield RadarFrame(power, az, valid.astype(bool), ts, stamp)
        finally:
            self.close()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.rsl_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
