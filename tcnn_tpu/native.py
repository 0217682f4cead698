"""ctypes bindings for the native host runtime (native/tcnn_host.cpp).

The reference's host/data path is C++/CUDA (texture sampling + device PCG32,
samples/mlp_learning_an_image.cu, random.h); where the host CPU feeds
batches, the equivalent runtime is a C++ shared library: deterministic
PCG32 batch generation with the reference's exact stream layout, and
OpenMP-parallel bilinear image sampling.

The library is built on demand with `make -C native` (g++); every entry
point has a numpy fallback with identical semantics, so the package works
without a toolchain (`HostRng(...).uniform(...)` etc. are always available).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
#: installed wheels carry the lib inside the package (setup.py build hook);
#: source checkouts build it on demand into native/ via the Makefile
_PKG_LIB_PATH = os.path.join(_PKG_DIR, "libtcnn_host.so")
_LIB_PATH = (
    _PKG_LIB_PATH if os.path.exists(_PKG_LIB_PATH)
    else os.path.join(_NATIVE_DIR, "libtcnn_host.so")
)

_lock = threading.Lock()
_lib = None
_lib_tried = False

PCG32_MULT = 0x5851F42D4C957F2D
_M64 = (1 << 64) - 1


def _load():
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
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

        u64p = ctypes.POINTER(ctypes.c_uint64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.tcnn_pcg32_seed.argtypes = [ctypes.c_uint64, ctypes.c_uint64, u64p, u64p]
        lib.tcnn_pcg32_next_uint.restype = ctypes.c_uint32
        lib.tcnn_pcg32_next_uint.argtypes = [u64p, ctypes.c_uint64]
        lib.tcnn_pcg32_advance.argtypes = [u64p, ctypes.c_uint64, ctypes.c_uint64]
        lib.tcnn_generate_random_uniform.argtypes = [
            u64p, u64p, ctypes.c_uint64, ctypes.c_float, ctypes.c_float, f32p,
        ]
        lib.tcnn_generate_random_logistic.argtypes = [
            u64p, u64p, ctypes.c_uint64, ctypes.c_float, ctypes.c_float, f32p,
        ]
        lib.tcnn_sample_image_bilinear.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            f32p, ctypes.c_int64, f32p,
        ]
        lib.tcnn_make_image_batch.argtypes = [
            u64p, u64p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, f32p, f32p,
        ]
        lib.tcnn_native_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# numpy fallback with identical semantics
# ---------------------------------------------------------------------------


def _np_pcg32_seed(initstate, initseq=1):
    inc = ((initseq << 1) | 1) & _M64
    state = 0
    state = (state * PCG32_MULT + inc) & _M64
    state = (state + initstate) & _M64
    state = (state * PCG32_MULT + inc) & _M64
    return state, inc


def _np_advance(state, inc, delta):
    cur_mult, cur_plus = PCG32_MULT, inc
    acc_mult, acc_plus = 1, 0
    while delta > 0:
        if delta & 1:
            acc_mult = (acc_mult * cur_mult) & _M64
            acc_plus = (acc_plus * cur_mult + cur_plus) & _M64
        cur_plus = ((cur_mult + 1) * cur_plus) & _M64
        cur_mult = (cur_mult * cur_mult) & _M64
        delta >>= 1
    return (acc_mult * state + acc_plus) & _M64


def _np_next_uints(state, inc, n):
    """Vectorized: n consecutive outputs starting at `state`."""
    # state_k = A^k s + (A^k-1)/(A-1) c; build iteratively in python ints
    # (n is at most ~4 here - per-thread draws; the batched path vectorizes
    # over threads, not draws)
    outs = []
    for _ in range(n):
        old = state
        state = (old * PCG32_MULT + inc) & _M64
        xorshifted = (((old >> 18) ^ old) >> 27) & 0xFFFFFFFF
        rot = old >> 59
        outs.append(((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & 0xFFFFFFFF)
    return state, outs


def _np_generate(state, inc, n, transform):
    t = ((n + 3) // 4 + 127) // 128 * 128
    # advance each virtual thread by 4i: states_i = A^{4i} s + d_i.
    # Compute the per-thread states with the affine recurrence for stride 4.
    a4 = 1
    c4 = 0
    for _ in range(4):
        a4 = (a4 * PCG32_MULT) & _M64
        c4 = (c4 * PCG32_MULT + inc) & _M64
    states = np.empty(t, np.uint64)
    s = state
    for i in range(t):
        states[i] = s
        s = (int(s) * a4 + c4) & _M64
    out = np.empty(n, np.float32)
    st = states.astype(object)
    for j in range(4):
        idx0 = np.arange(t, dtype=np.int64) + t * j
        mask = idx0 < n
        if not mask.any():
            break
        old = np.asarray([int(v) for v in st], object)
        xorshifted = np.asarray(
            [(((o >> 18) ^ o) >> 27) & 0xFFFFFFFF for o in old], np.uint64
        ).astype(np.uint32)
        rot = np.asarray([o >> 59 for o in old], np.uint64).astype(np.uint32)
        u = (xorshifted >> rot) | (
            xorshifted << ((32 - rot) & 31)
        )
        u = np.where(rot == 0, xorshifted, u)
        f = ((u >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - 1.0
        out[idx0[mask]] = transform(f[mask])
        st = [(int(o) * PCG32_MULT + inc) & _M64 for o in old]
    new_state = _np_advance(state, inc, n)
    return new_state, out


def _np_sample_bilinear(image, xy):
    h, w = image.shape[:2]
    fx = xy[:, 0] * w - 0.5
    fy = xy[:, 1] * h - 0.5
    x0 = np.floor(fx)
    y0 = np.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)

    def at(yi, xi):
        return image[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]

    top = at(y0, x0) * (1 - tx) + at(y0, x0 + 1) * tx
    bot = at(y0 + 1, x0) * (1 - tx) + at(y0 + 1, x0 + 1) * tx
    return (top * (1 - ty) + bot * ty).astype(np.float32)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class HostRng:
    """Deterministic PCG32 batch generator, reference stream layout
    (random.h:39-66). Seeded like `default_rng_t rng{1337}`."""

    def __init__(self, seed: int = 1337, initseq: int = 1, use_native=None):
        self._native = _load() if use_native in (None, True) else None
        if use_native is True and self._native is None:
            raise RuntimeError("native tcnn_host library unavailable")
        if self._native is not None:
            self._state = ctypes.c_uint64(0)
            self._inc = ctypes.c_uint64(0)
            self._native.tcnn_pcg32_seed(
                seed & _M64, initseq & _M64,
                ctypes.byref(self._state), ctypes.byref(self._inc),
            )
        else:
            self._py_state, self._py_inc = _np_pcg32_seed(seed, initseq)

    @property
    def state(self) -> int:
        if self._native is not None:
            return int(self._state.value)
        return self._py_state

    def advance(self, delta: int) -> None:
        if self._native is not None:
            self._native.tcnn_pcg32_advance(
                ctypes.byref(self._state), self._inc, delta & _M64
            )
        else:
            self._py_state = _np_advance(self._py_state, self._py_inc, delta)

    def next_uint(self) -> int:
        if self._native is not None:
            return int(
                self._native.tcnn_pcg32_next_uint(
                    ctypes.byref(self._state), self._inc
                )
            )
        self._py_state, outs = _np_next_uints(self._py_state, self._py_inc, 1)
        return outs[0]

    def uniform(self, n: int, lower: float = 0.0, upper: float = 1.0):
        out = np.empty(n, np.float32)
        if self._native is not None:
            self._native.tcnn_generate_random_uniform(
                ctypes.byref(self._state), ctypes.byref(self._inc),
                n, lower, upper,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out
        self._py_state, out = _np_generate(
            self._py_state, self._py_inc, n,
            lambda f: f * (upper - lower) + lower,
        )
        return out

    def logistic(self, n: int, mean: float = 0.0, stddev: float = 1.0):
        out = np.empty(n, np.float32)
        if self._native is not None:
            self._native.tcnn_generate_random_logistic(
                ctypes.byref(self._state), ctypes.byref(self._inc),
                n, mean, stddev,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out

        def tr(f):
            f = np.clip(f, 1e-7, 1 - 1e-7)
            return np.log(f / (1 - f)) * stddev * 0.551328895 + mean

        self._py_state, out = _np_generate(
            self._py_state, self._py_inc, n, tr
        )
        return out

    def image_batch(self, image: np.ndarray, batch: int):
        """(xy [B,2], rgb [B,C]) - one fused native call per training step."""
        image = np.ascontiguousarray(image, np.float32)
        h, w, c = image.shape
        if self._native is not None:
            xy = np.empty((batch, 2), np.float32)
            rgb = np.empty((batch, c), np.float32)
            f32p = ctypes.POINTER(ctypes.c_float)
            self._native.tcnn_make_image_batch(
                ctypes.byref(self._state), ctypes.byref(self._inc),
                image.ctypes.data_as(f32p), h, w, c, batch,
                xy.ctypes.data_as(f32p), rgb.ctypes.data_as(f32p),
            )
            return xy, rgb
        xy = self.uniform(batch * 2).reshape(batch, 2)
        return xy, _np_sample_bilinear(image, xy)


def sample_image_bilinear(image: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """OpenMP bilinear sampling (native when available)."""
    image = np.ascontiguousarray(image, np.float32)
    xy = np.ascontiguousarray(xy, np.float32)
    lib = _load()
    if lib is None:
        return _np_sample_bilinear(image, xy)
    h, w, c = image.shape
    out = np.empty((xy.shape[0], c), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tcnn_sample_image_bilinear(
        image.ctypes.data_as(f32p), h, w, c,
        xy.ctypes.data_as(f32p), xy.shape[0],
        out.ctypes.data_as(f32p),
    )
    return out
