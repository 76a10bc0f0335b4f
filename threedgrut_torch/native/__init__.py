"""The native (C++) image decoder, built on first use with the system g++
and loaded with ctypes: a thread pool that decodes PNG and JPEG frames into
float32 buffers off the GIL (dataloader.cpp, the port's copy of the JAX
package's).

The library is built into `build/` at the repository root under a name that
carries a hash of the source and the flags, so an edited source is rebuilt;
it is compiled to a temporary name and moved into place, so that processes
building at once (test workers) never load a half-written file. Importing
this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lpng", "-ljpeg", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    return BUILD_DIR / f"libdataloader-{h.hexdigest()[:12]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(SOURCE), *_LIBS, "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def _declare(lib: ctypes.CDLL) -> None:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.dl_image_info.argtypes = [ctypes.c_char_p, c_int_p, c_int_p, c_int_p]
    lib.dl_image_info.restype = ctypes.c_int
    lib.dl_decode.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_long,
                              c_int_p, c_int_p, c_int_p]
    lib.dl_decode.restype = ctypes.c_int
    lib.dl_create.argtypes = [ctypes.c_int]
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_submit.argtypes = [ctypes.c_void_p, ctypes.c_long,
                              ctypes.c_char_p]
    lib.dl_submit.restype = None
    lib.dl_wait.argtypes = [ctypes.c_void_p, ctypes.c_long, c_float_p,
                            ctypes.c_long, c_int_p, c_int_p, c_int_p]
    lib.dl_wait.restype = ctypes.c_int
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    lib.dl_destroy.restype = None


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once per source) and load the decoder; None where it cannot
    be built or loaded (`build_error()` says why)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        except subprocess.CalledProcessError as e:
            _build_error = f"g++ failed (exit {e.returncode}): {e.stderr}"
        except OSError as e:
            _build_error = str(e)
        return _lib


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was, or if
    no load was tried yet)."""
    return _build_error
