"""The port's host libraries through ``ctypes``: the LZ4 block codec and
blosc byte shuffle (``csrc/lz4.cpp``), beside their plain Python versions,
and Farnebäck optical flow with its warp (``csrc/farneback.cpp``).

A copy of the JAX package's ``native.py``. The libraries are built by
:mod:`~predict_pv_yield_tpu_torch._build` with the host compiler on first
use, into ``build/torch_kernels/``. A failed build raises with the
compiler's output: the blosc reader never falls back to the Python codec on
its own, and flow has no Python fallback on the host (the port's flow runs
on the card, ``ops/optical_flow.py``). The ``*_plain`` functions are the
codec's Python versions (a byte-serial LZ4 decoder, an all-literals LZ4
encoder and numpy transposes for the shuffle); the tests and
``chip_smoke.py`` hold the native codec to them. The host flow is the
single-core rate that ``flow_bench.py`` sets the card's against.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from predict_pv_yield_tpu_torch import _build

_lib: Optional[ctypes.CDLL] = None
_flow_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The built ``csrc/lz4.cpp`` with its signatures declared (building it
    on the first call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = _build.load("lz4")
            byte_ptr = ctypes.POINTER(ctypes.c_uint8)
            for codec in (lib.lz4_decompress_block, lib.lz4_compress_block):
                codec.argtypes = [byte_ptr, ctypes.c_long, byte_ptr, ctypes.c_long]
                codec.restype = ctypes.c_long
            for shuffle in (lib.blosc_shuffle, lib.blosc_unshuffle):
                shuffle.argtypes = [byte_ptr, byte_ptr, ctypes.c_long, ctypes.c_long]
                shuffle.restype = None
            _lib = lib
    return _lib


def load_flow_library() -> ctypes.CDLL:
    """The built ``csrc/farneback.cpp`` with its signatures declared
    (building it on the first call)."""
    global _flow_lib
    if _flow_lib is not None:
        return _flow_lib
    with _lock:
        if _flow_lib is None:
            lib = _build.load("farneback")
            float_ptr = ctypes.POINTER(ctypes.c_float)
            options = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
            lib.farneback_flow.argtypes = [float_ptr, float_ptr, ctypes.c_int, ctypes.c_int, float_ptr, *options]
            lib.farneback_flow_sequence.argtypes = [
                float_ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, float_ptr, *options]
            lib.remap_image.argtypes = [float_ptr, float_ptr, ctypes.c_int, ctypes.c_int, float_ptr]
            for function in (lib.farneback_flow, lib.farneback_flow_sequence, lib.remap_image):
                function.restype = None
            _flow_lib = lib
    return _flow_lib


def _as_float_ptr(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _flow_options(levels=2, winsize=40, iterations=3, poly_n=5, poly_sigma=0.7, gaussian=True):
    """The C functions' trailing arguments, at OpenCV's defaults as the
    nowcast uses them."""
    return levels, winsize, iterations, poly_n, ctypes.c_float(poly_sigma), int(gaussian)


def farneback_flow_native(
    im1: np.ndarray,
    im2: np.ndarray,
    levels: int = 2,
    winsize: int = 40,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 0.7,
    gaussian: bool = True,
) -> np.ndarray:
    """Host C++ Farnebäck flow of two (H, W) frames → (H, W, 2) float32
    (dx, dy)."""
    lib = load_flow_library()
    im1 = np.ascontiguousarray(im1, dtype=np.float32)
    im2 = np.ascontiguousarray(im2, dtype=np.float32)
    if im1.ndim != 2 or im1.shape != im2.shape:
        raise ValueError(f"frames must be two (H, W) arrays of one shape, got {im1.shape} and {im2.shape}")
    height, width = im1.shape
    flow = np.empty((height, width, 2), dtype=np.float32)
    lib.farneback_flow(
        _as_float_ptr(im1), _as_float_ptr(im2), height, width, _as_float_ptr(flow),
        *_flow_options(levels, winsize, iterations, poly_n, poly_sigma, gaussian),
    )
    return flow


def flow_sequence_native(frames: np.ndarray, **kwargs) -> np.ndarray:
    """(T, H, W) → (T-1, H, W, 2): the flow of each consecutive pair, one
    after the other on one core; ``kwargs`` as :func:`farneback_flow_native`."""
    lib = load_flow_library()
    frames = np.ascontiguousarray(frames, dtype=np.float32)
    if frames.ndim != 3 or frames.shape[0] < 2:
        raise ValueError(f"frames must be (T >= 2, H, W), got {frames.shape}")
    t, height, width = frames.shape
    flows = np.empty((t - 1, height, width, 2), dtype=np.float32)
    lib.farneback_flow_sequence(
        _as_float_ptr(frames), t, height, width, _as_float_ptr(flows), *_flow_options(**kwargs)
    )
    return flows


def remap_image_native(image: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Warp (H, W) ``image`` forward by (H, W, 2) ``flow``: out(y, x) =
    image(y − dy, x − dx), bilinear, NaN where the sample's support leaves
    the frame."""
    lib = load_flow_library()
    image = np.ascontiguousarray(image, dtype=np.float32)
    flow = np.ascontiguousarray(flow, dtype=np.float32)
    if image.ndim != 2 or flow.shape != (*image.shape, 2):
        raise ValueError(f"image (H, W) and flow (H, W, 2) expected, got {image.shape} and {flow.shape}")
    height, width = image.shape
    out = np.empty((height, width), dtype=np.float32)
    lib.remap_image(_as_float_ptr(image), _as_float_ptr(flow), height, width, _as_float_ptr(out))
    return out


def _as_byte_ptr(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def lz4_decompress(data: bytes, decompressed_size: int) -> bytes:
    """Decompress one raw LZ4 block (``csrc/lz4.cpp``)."""
    lib = load_library()
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(decompressed_size, dtype=np.uint8)
    written = lib.lz4_decompress_block(_as_byte_ptr(src), len(src), _as_byte_ptr(dst), decompressed_size)
    if written != decompressed_size:
        raise ValueError(f"malformed LZ4 block: wrote {written}, expected {decompressed_size}")
    return dst.tobytes()


def lz4_compress(data: bytes) -> bytes:
    """Compress one raw LZ4 block (greedy matcher, format-conformant)."""
    lib = load_library()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(src) + len(src) // 255 + 32
    dst = np.empty(cap, dtype=np.uint8)
    written = lib.lz4_compress_block(_as_byte_ptr(src), len(src), _as_byte_ptr(dst), cap)
    if written < 0:
        raise ValueError("LZ4 compression overflow")
    return dst[:written].tobytes()


def _shuffle(symbol: str, data: bytes, typesize: int) -> bytes:
    n_shuffled = len(data) - len(data) % typesize
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(len(data), dtype=np.uint8)
    getattr(load_library(), symbol)(_as_byte_ptr(src), _as_byte_ptr(dst), n_shuffled, typesize)
    dst[n_shuffled:] = src[n_shuffled:]
    return dst.tobytes()


def byte_shuffle(data: bytes, typesize: int) -> bytes:
    """blosc's byte shuffle over complete elements; the tail (``len %
    typesize`` bytes) is copied through unchanged, as c-blosc does."""
    return _shuffle("blosc_shuffle", data, typesize)


def byte_unshuffle(data: bytes, typesize: int) -> bytes:
    """Inverse of :func:`byte_shuffle`."""
    return _shuffle("blosc_unshuffle", data, typesize)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def lz4_decompress_plain(src: bytes, out_size: int) -> bytes:
    """Pure-Python LZ4 block decode: slow but format-complete."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                extra = src[i]
                i += 1
                lit += extra
                if extra != 255:
                    break
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break  # final sequence carries literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError("malformed LZ4 block: bad match offset")
        mlen = token & 0xF
        if mlen == 15:
            while True:
                extra = src[i]
                i += 1
                mlen += extra
                if extra != 255:
                    break
        mlen += 4
        start = len(out) - offset
        for _ in range(mlen):  # byte-serial: overlapping copies are legal
            out.append(out[start])
            start += 1
    if len(out) != out_size:
        raise ValueError(f"malformed LZ4 block: wrote {len(out)}, expected {out_size}")
    return bytes(out)


def lz4_compress_plain(payload: bytes) -> bytes:
    """An all-literals LZ4 block: valid, never smaller than the input."""
    out = bytearray()
    lit = len(payload)
    out.append((15 if lit >= 15 else lit) << 4)
    if lit >= 15:
        rest = lit - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += payload
    return bytes(out)


def byte_shuffle_plain(data: bytes, typesize: int) -> bytes:
    n = len(data) - len(data) % typesize
    src = np.frombuffer(data, dtype=np.uint8)
    body = src[:n].reshape(n // typesize, typesize).T.reshape(-1)
    return body.tobytes() + src[n:].tobytes()


def byte_unshuffle_plain(data: bytes, typesize: int) -> bytes:
    n = len(data) - len(data) % typesize
    src = np.frombuffer(data, dtype=np.uint8)
    body = src[:n].reshape(typesize, n // typesize).T.reshape(-1)
    return body.tobytes() + src[n:].tobytes()
