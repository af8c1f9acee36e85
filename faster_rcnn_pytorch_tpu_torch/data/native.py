"""ctypes bindings for the native data-loader core (native/image_ops.cpp).

Builds lazily with ``make -C native`` on first use if g++ is available;
every function has a numpy fallback so the pipeline works without the
shared library (e.g. in restricted CI).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libimage_ops.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.resize_bilinear_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
    lib.normalize_into_canvas.argtypes = [u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int]
    lib.hflip_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int]
    lib.jpeg_dims.argtypes = [u8p, ctypes.c_long, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.jpeg_dims.restype = ctypes.c_int
    lib.decode_jpeg_rgb.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_int, ctypes.c_int]
    lib.decode_jpeg_rgb.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def normalize_into_canvas(
    image: np.ndarray, canvas_h: int, canvas_w: int
) -> np.ndarray:
    """uint8 [h,w,3] -> float32 [canvas_h,canvas_w,3] normalised, padded."""
    lib = _load()
    h, w = image.shape[:2]
    if lib is None:
        from faster_rcnn_pytorch_tpu_torch.data.transforms import normalize

        out = np.zeros((canvas_h, canvas_w, 3), np.float32)
        out[:h, :w] = normalize(image)
        return out
    image = np.ascontiguousarray(image)
    out = np.empty((canvas_h, canvas_w, 3), np.float32)
    lib.normalize_into_canvas(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        canvas_h,
        canvas_w,
    )
    return out


def resize_bilinear(image: np.ndarray, dh: int, dw: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        from PIL import Image

        return np.asarray(
            Image.fromarray(image).resize((dw, dh), Image.BILINEAR)
        )
    image = np.ascontiguousarray(image)
    sh, sw = image.shape[:2]
    out = np.empty((dh, dw, 3), np.uint8)
    lib.resize_bilinear_u8(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sh,
        sw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dh,
        dw,
    )
    return out


def decode_jpeg(path: str) -> np.ndarray | None:
    """Native JPEG -> uint8 HWC RGB via libjpeg (the same C library the
    system PIL wraps), bypassing PIL object overhead; the GIL is released
    for the whole decode (ctypes). Returns None if the native library is
    unavailable or the file is not a decodable JPEG (caller falls back
    to PIL — e.g. PNGs take that path)."""
    lib = _load()
    if lib is None:
        return None
    try:
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
    except OSError:
        return None
    if data.size < 3 or data[0] != 0xFF or data[1] != 0xD8:
        return None  # not a JPEG signature
    h = ctypes.c_int()
    w = ctypes.c_int()
    dp = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if lib.jpeg_dims(dp, data.size, ctypes.byref(h), ctypes.byref(w)):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.decode_jpeg_rgb(
        dp,
        data.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h.value,
        w.value,
    )
    return out if rc == 0 else None


def native_image_loader(path: str) -> np.ndarray:
    """Drop-in for ``loader.load_image``: libjpeg fast path, PIL fallback."""
    out = decode_jpeg(path)
    if out is not None:
        return out
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
