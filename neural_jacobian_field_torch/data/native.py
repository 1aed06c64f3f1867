"""ctypes bindings for the native batch decoder, csrc/njf_loader.cpp (the
port's copy of data/native.py). The library is built on first use with
g++ (libpng, libjpeg, zlib) into build/native_loader/ at the repo's root,
never beside the source. It is a host acceleration only: where it does not
build (no g++, no libpng or libjpeg headers), `get_lib()` is None, every
entry point returns None, and the per-item path (data/image_io.py) serves.
`status()` says which, and why."""

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .image_io import DECODED

_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "csrc" / "njf_loader.cpp"
_LIB_PATH = _REPO / "build" / "native_loader" / "libnjf_loader.so"
_lock = threading.Lock()
_lib = None
_lib_failed = False
_why = "not built yet"


def _build() -> bool:
    global _why
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        str(_SRC), "-o", str(tmp), "-lpng", "-ljpeg", "-lz",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except subprocess.CalledProcessError as e:
        err = e.stderr.decode(errors="replace").strip().splitlines()
        _why = f"g++ failed: {err[0] if err else e}"
        return False
    except (subprocess.TimeoutExpired, FileNotFoundError) as e:
        _why = f"g++ unavailable: {e}"
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def status() -> str:
    """"native" where the library is loaded, else "unavailable (<why>)"."""
    return "native" if get_lib() is not None else f"unavailable ({_why})"


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native loader; None if unavailable."""
    global _lib, _lib_failed, _why
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not _LIB_PATH.exists() and not _build():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError as e:
            _why = f"cannot load {_LIB_PATH.name}: {e}"
            _lib_failed = True
            return None
        lib.njf_decode_rgb_batch.restype = ctypes.c_int
        lib.njf_decode_rgb_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.njf_decode_depth_batch.restype = ctypes.c_int
        lib.njf_decode_depth_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int,
        ]
        if not (hasattr(lib, "njf_load_flow_npz_batch")
                and hasattr(lib, "njf_decode_rgb_batch_u8")):
            # stale prebuilt library from before the flow reader existed
            if _build():
                lib = ctypes.CDLL(str(_LIB_PATH))
            else:
                _lib_failed = True
                return None
        lib.njf_load_flow_npz_batch.restype = ctypes.c_int
        lib.njf_load_flow_npz_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.njf_decode_rgb_batch_u8.restype = ctypes.c_int
        lib.njf_decode_rgb_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def _paths_array(paths: Sequence) -> "ctypes.Array":
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def decode_rgb_batch(paths: Sequence, height: int, width: int,
                     threads: int = 8) -> Optional[np.ndarray]:
    """Decode image files -> float32 [N, H, W, 3] in [0,1]; None if the
    native library is unavailable. Raises on decode failure."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((len(paths), height, width, 3), np.float32)
    rc = lib.njf_decode_rgb_batch(
        _paths_array(paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), height, width,
        threads,
    )
    if rc != 0:
        raise IOError(f"native decode failed for {paths[rc - 1]}")
    DECODED["native"] += len(paths)
    return out


def decode_depth_batch(paths: Sequence, height: int, width: int,
                       scale: float, threads: int = 8) -> Optional[np.ndarray]:
    """Decode 16-bit depth PNGs -> float32 [N, H, W, 1] * scale."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((len(paths), height, width), np.float32)
    rc = lib.njf_decode_depth_batch(
        _paths_array(paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), height, width,
        ctypes.c_float(scale), threads,
    )
    if rc != 0:
        raise IOError(f"native depth decode failed for {paths[rc - 1]}")
    return out[..., None]


def decode_rgb_batch_u8(paths: Sequence, height: int, width: int,
                        threads: int = 8) -> Optional[np.ndarray]:
    """Decode image files -> uint8 [N, H, W, 3] (the host->device wire
    format: 4x fewer bytes than f32; prepare_training_batch normalizes on
    device). None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((len(paths), height, width, 3), np.uint8)
    rc = lib.njf_decode_rgb_batch_u8(
        _paths_array(paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), height, width,
        threads,
    )
    if rc != 0:
        raise IOError(f"native decode failed for {paths[rc - 1]}")
    DECODED["native"] += len(paths)
    return out


def load_flow_npz_batch(paths: Sequence, height: int, width: int,
                        threads: int = 8) -> Optional[np.ndarray]:
    """Load RAFT-flow .npz files -> float32 [N, H, W, 2] (accepts [H, W, 2]
    or [2, H, W] f32/f64 payloads — utils/io_utils.load_optical_flow
    semantics). None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((len(paths), height, width, 2), np.float32)
    rc = lib.njf_load_flow_npz_batch(
        _paths_array(paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), height, width,
        threads,
    )
    if rc != 0:
        raise IOError(f"native flow load failed for {paths[rc - 1]}")
    return out
