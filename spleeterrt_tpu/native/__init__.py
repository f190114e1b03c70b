"""ctypes binding for the native host runtime (audioio.cpp).

Builds lazily with g++ on first use (no pip deps); all entry points have
pure-NumPy fallbacks in spleeterrt_tpu/io, so the framework works without a
toolchain. `get_lib()` returns None when unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "audioio.cpp")
_SRC_FLAC = os.path.join(_HERE, "flacdec.cpp")
_LIB_PATH = os.path.join(_HERE, "_audioio.so")
_lock = threading.Lock()
_lib = None
_tried = False

u64 = ctypes.c_uint64
i32 = ctypes.c_int32
f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def build(force: bool = False) -> str | None:
    """Compile audioio.cpp -> _audioio.so; returns path or None."""
    if not force and os.path.exists(_LIB_PATH):
        src_m = max(os.path.getmtime(_SRC), os.path.getmtime(_SRC_FLAC))
        if os.path.getmtime(_LIB_PATH) >= src_m:
            return _LIB_PATH
    # Build beside the target and rename: processes that build at once
    # (test workers) never load a half-written library.
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        _SRC, _SRC_FLAC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB_PATH


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.srt_wav_info.argtypes = [
            u8p, u64, ctypes.POINTER(i32), ctypes.POINTER(i32),
            ctypes.POINTER(i32), ctypes.POINTER(i32), ctypes.POINTER(u64),
            ctypes.POINTER(u64), ctypes.POINTER(u64),
        ]
        lib.srt_wav_info.restype = i32
        lib.srt_wav_decode.argtypes = [u8p, u64, i32, i32, i32, f32p, u64]
        lib.srt_wav_decode.restype = i32
        lib.srt_wav_encode.argtypes = [f32p, i32, u64, i32, u8p]
        lib.srt_wav_encode.restype = i32
        lib.srt_resample.argtypes = [f32p, u64, i32, f64p, i32, i32, i32, f32p, u64]
        lib.srt_resample.restype = i32
        lib.srt_split_channels.argtypes = [f32p, i32, u64, u64, u64, f32p]
        lib.srt_join_channels.argtypes = [f32p, i32, u64, u64, u64, f32p]
        lib.srt_version.restype = ctypes.c_char_p
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.srt_flac_info.argtypes = [
            u8p, u64, ctypes.POINTER(i32), ctypes.POINTER(i32),
            ctypes.POINTER(i32), ctypes.POINTER(u64), ctypes.POINTER(u64),
        ]
        lib.srt_flac_info.restype = i32
        lib.srt_flac_decode.argtypes = [u8p, u64, u64, i32, i32, u64, i32p]
        lib.srt_flac_decode.restype = ctypes.c_int64
        _lib = lib
        return _lib


def read_wav_native(data: bytes):
    """Returns (planar float32 (ch, n), sample_rate) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    ch, rate, bits, tag = i32(), i32(), i32(), i32()
    frames, off, dlen = u64(), u64(), u64()
    rc = lib.srt_wav_info(
        buf, buf.size, ctypes.byref(ch), ctypes.byref(rate),
        ctypes.byref(bits), ctypes.byref(tag), ctypes.byref(frames),
        ctypes.byref(off), ctypes.byref(dlen),
    )
    if rc != 0:
        raise ValueError(f"native WAV parse failed ({rc})")
    out = np.empty((ch.value, frames.value), np.float32)
    payload = np.ascontiguousarray(buf[off.value : off.value + dlen.value])
    rc = lib.srt_wav_decode(
        payload, dlen.value, ch.value, bits.value, tag.value, out, frames.value
    )
    if rc != 0:
        raise ValueError(f"native WAV decode failed ({rc})")
    return out, rate.value


def resample_native(
    x: np.ndarray, h: np.ndarray, p: int, q: int, n_out: int
) -> np.ndarray | None:
    """Polyphase resample (batch, n) with filter h; None if lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    batch, n = x.shape
    h = np.ascontiguousarray(h, np.float64)
    out = np.empty((batch, n_out), np.float32)
    rc = lib.srt_resample(x, n, batch, h, h.size, p, q, out, n_out)
    if rc != 0:
        raise ValueError(f"native resample failed ({rc})")
    return out


def decode_flac_native(data: bytes):
    """FLAC bytes -> (float32 planar (ch, n), rate); None if lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    ch, rate, bps = i32(), i32(), i32()
    total, off = u64(), u64()
    rc = lib.srt_flac_info(
        buf, buf.size, ctypes.byref(ch), ctypes.byref(rate),
        ctypes.byref(bps), ctypes.byref(total), ctypes.byref(off),
    )
    if rc != 0:
        raise ValueError(f"native FLAC parse failed ({rc})")
    n = total.value
    out = np.zeros((ch.value, n), np.int32)
    done = lib.srt_flac_decode(
        buf, buf.size, off.value, ch.value, bps.value, n, out
    )
    if done < 0:
        raise ValueError(f"native FLAC decode failed ({done})")
    scale = np.float32(1 << (bps.value - 1))
    return out[:, :done].astype(np.float32) / scale, rate.value
