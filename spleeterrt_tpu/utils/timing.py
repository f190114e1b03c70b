"""Tracing / profiling utilities.

The reference's observability is wall/CPU-clock printf timing
(Executable/main.c:21-52, :772-965) and a disabled PNG spectrogram dumper
(VST/Source/Spleeter4Stems.c:218-256). Equivalents here: stage timers
that force device completion, `jax.profiler` trace scoping, and spectrogram
dumps to PNG via pure NumPy.
"""

from __future__ import annotations

import contextlib
import time
import zlib
import struct
from dataclasses import dataclass, field

import jax
import numpy as np


@dataclass
class StageTimer:
    """Named stage wall-clock timing with device sync, printf-style report."""

    stages: dict[str, float] = field(default_factory=dict)
    verbose: bool = True

    @contextlib.contextmanager
    def stage(self, name: str, sync: object = None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        if self.verbose:
            print(f"{name} takes {dt:.6f} sec")

    def report(self) -> dict[str, float]:
        return dict(self.stages)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Scoped jax.profiler trace; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def write_gray_png(path: str, img: np.ndarray) -> None:
    """Minimal 8-bit grayscale PNG writer (no deps)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def dump_spectrogram_pngs(
    x: np.ndarray, folder: str, lin_gain: float = 10.0
) -> list[str]:
    """Per-channel magnitude/mask plane dumps, the debug instrument of
    `writeNChannelsImg2Folder` (VST/Source/Spleeter4Stems.c:220-256)."""
    import os

    os.makedirs(folder, exist_ok=True)
    x = np.asarray(x)
    paths = []
    for s in range(x.shape[0]):
        img = np.abs(x[s]) * lin_gain
        p = f"{folder}/{s}.png"
        write_gray_png(p, img)
        paths.append(p)
    return paths
