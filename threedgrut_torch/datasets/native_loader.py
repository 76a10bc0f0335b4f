"""Prefetching image loader over the native C++ decoder
(threedgrut_torch/native), port of threedgrut_tpu/datasets/native_loader.py.

Where the library cannot be built (no g++, or no libpng/libjpeg headers),
frames are decoded with PIL, as in the JAX package. The chain is visible:
`ImageLoader.native` and `decoder_name()` say which decoder runs. Typical
use:

    loader = ImageLoader(n_threads=8)
    loader.prefetch([path0, path1, ...])      # pipeline ahead
    img = loader.get(path0)                    # float32 [H, W, C] in [0, 1]
"""
from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np

from threedgrut_torch.native import load_library


def _pil_decode(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im, dtype=np.float32) / 255.0


def decoder_name() -> str:
    """"native" where the C++ decoder builds and loads, else "pil"."""
    return "native" if load_library() is not None else "pil"


class ImageLoader:
    def __init__(self, n_threads: int = 8,
                 max_bytes: int = 64 * 1024 * 1024):
        self._lib = load_library()
        self._handle = None
        self._tickets: Dict[str, int] = {}
        self._next_ticket = 0
        self._cap = max_bytes // 4
        if self._lib is not None:
            self._handle = self._lib.dl_create(n_threads)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def prefetch(self, paths: List[str]) -> None:
        """Queue the decode of `paths` on the thread pool (a no-op with
        PIL)."""
        if self._handle is None:
            return
        for p in paths:
            if p not in self._tickets:
                self._tickets[p] = self._next_ticket
                self._lib.dl_submit(self._handle, self._next_ticket,
                                    p.encode())
                self._next_ticket += 1

    def _native_call(self, fn, *args) -> np.ndarray:
        buf = np.empty(self._cap, np.float32)
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = fn(*args, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._cap, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
        if rc != 0:
            return None
        n = w.value * h.value * c.value
        return buf[:n].reshape(h.value, w.value, c.value).copy()

    def get(self, path: str) -> np.ndarray:
        """The decoded image at `path` (prefetched or not); PIL where the
        native decoder is missing or cannot read the file."""
        if self._handle is None:
            return _pil_decode(path)
        if path not in self._tickets:
            self.prefetch([path])
        img = self._native_call(self._lib.dl_wait, self._handle,
                                self._tickets.pop(path))
        return _pil_decode(path) if img is None else img

    def decode(self, path: str) -> np.ndarray:
        """Synchronous single-image decode (no prefetch queue)."""
        if self._lib is None:
            return _pil_decode(path)
        img = self._native_call(self._lib.dl_decode, path.encode())
        return _pil_decode(path) if img is None else img

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def load_rgb(loader: ImageLoader, path: str) -> np.ndarray:
    """A frame as float32 [H, W, C >= 3]: a grey image is repeated to RGB."""
    img = loader.get(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return img
