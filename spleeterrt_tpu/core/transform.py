"""Batched STFT / iSTFT with the reference's exact window semantics.

The reference implements the transform as a hand-unrolled 4096-point fast
Hartley transform plus Hartley<->complex unpacking (Executable/codelet.c:2,
Executable/stftFix.c:144-155). Numerically that detour is a standard real FFT
with a chain of scale factors; here `jnp.fft.rfft` (cuFFT on the GPU) runs
batched over all frames at once and fold the scale chain into the windows:

- Analysis window (Executable/stftFix.c:48-57, :302-308): periodic Hann with a
  half-sample offset, `0.5 * (1 - cos(2*pi*(i+0.5)/N))`, carrying a
  `1/N * 2/LAP` scale in C. The C pipeline then multiplies magnitudes by
  FFTSIZE and re/im unpacking contributes a factor 2, so the magnitude the
  U-Net sees is exactly `|rfft(frame * hann_offset)|` -- we use the unscaled
  window and skip all compensating constants.
- Synthesis ("post") window (Executable/stftFix.c:64-75, :310-312): the same
  Hann times 2/3 for 75% overlap; sum_k hann^2(n - k*hop) = 3/2, giving a
  unity-gain mask-of-ones round trip.

Frame layout matches the offline driver (Executable/stftFix.c:363-495):
frames at positions 0, hop, .., rangeM where
`rangeM = ((data_size - N + hop/LAP) // hop) * hop`, a final zero-padded
frame at rangeM, and `ceil(data_size / hop)` total rows (the excess rows stay
zero). iSTFT overlap-adds all rows (Executable/stftFix.c:496-579).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spleeterrt_tpu.config import TransformConfig


def analysis_window(fft_size: int, dtype=jnp.float32) -> jax.Array:
    """Periodic Hann with half-sample offset (Executable/stftFix.c:48-57)."""
    i = np.arange(fft_size, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * (i + 0.5) / fft_size))
    return jnp.asarray(w, dtype=dtype)


def synthesis_window(cfg: TransformConfig, dtype=jnp.float32) -> jax.Array:
    """Post window: Hann * 2/3 for LAP=4 (Executable/stftFix.c:64-75,310-312)."""
    return analysis_window(cfg.fft_size, dtype) * cfg.synthesis_gain


def num_output_frames(data_size: int, cfg: TransformConfig) -> int:
    """Rows of the spectrogram: ceil(data_size/hop) (Executable/stftFix.c:367)."""
    return -(-data_size // cfg.hop)


def num_computed_frames(data_size: int, cfg: TransformConfig) -> int:
    """Frames actually transformed; the rest stay zero (stftFix.c:377,460)."""
    hop = cfg.hop
    range_m = ((data_size - cfg.fft_size + hop // cfg.overlap) // hop) * hop
    return range_m // hop + 1


def frame_signal(x: jax.Array, cfg: TransformConfig, data_size: int) -> jax.Array:
    """Slice (..., data_size) into (..., n_frames, fft_size) hop-strided frames.

    hop divides fft_size, so framing is `overlap` shifted reshapes
    concatenated along the window axis -- no gather, XLA-friendly.
    Rows beyond the computed range are zero, matching the reference.
    """
    hop, n = cfg.hop, cfg.fft_size
    lap = cfg.overlap
    n_out = num_output_frames(data_size, cfg)
    n_comp = num_computed_frames(data_size, cfg)
    # Blocks needed so every computed frame can read `lap` consecutive blocks.
    n_blocks = n_comp - 1 + lap
    pad = n_blocks * hop - data_size
    if pad < 0:
        x = x[..., : n_blocks * hop]
    else:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    blocks = x.reshape(*x.shape[:-1], n_blocks, hop)
    frames = jnp.concatenate(
        [blocks[..., k : k + n_comp, :] for k in range(lap)], axis=-1
    )
    if n_out > n_comp:
        frames = jnp.pad(
            frames, [(0, 0)] * (frames.ndim - 2) + [(0, n_out - n_comp), (0, 0)]
        )
    return frames


@functools.partial(jax.jit, static_argnames=("cfg", "data_size"))
def stft(x: jax.Array, cfg: TransformConfig, data_size: int) -> jax.Array:
    """STFT of (..., data_size) real audio -> (..., n_frames, num_bins) complex.

    `abs(spec)` equals the magnitude the reference feeds the U-Net
    (hypotf(re, im) * FFTSIZE, Executable/main.c:468 with the C window
    scaling folded in).
    """
    frames = frame_signal(x, cfg, data_size)
    w = analysis_window(cfg.fft_size, frames.dtype)
    return jnp.fft.rfft(frames * w, axis=-1)


def overlap_add(frames: jax.Array, cfg: TransformConfig) -> jax.Array:
    """(..., n_frames, fft_size) -> (..., n_frames*hop + (fft_size-hop)).

    hop divides fft_size: split each frame into `overlap` hop-chunks and sum
    shifted chunk streams -- `overlap` adds instead of a scatter.
    """
    hop, lap = cfg.hop, cfg.overlap
    n_frames = frames.shape[-2]
    # Output block b (of n_frames + lap - 1) sums frames[b - c, c*hop:...].
    # A sum of shift-padded slices fuses into one elementwise pass, with no
    # scatter.
    nb = frames.ndim - 2  # batch dims before (n_frames, fft_size)
    pad = [(0, 0)] * nb
    out = None
    for c in range(lap):
        part = jnp.pad(
            frames[..., :, c * hop : (c + 1) * hop],
            pad + [(c, lap - 1 - c), (0, 0)],
        )
        out = part if out is None else out + part
    return out.reshape(*frames.shape[:-2], (n_frames + lap - 1) * hop)


@functools.partial(jax.jit, static_argnames=("cfg",))
def istft(spec: jax.Array, cfg: TransformConfig) -> jax.Array:
    """Inverse of :func:`stft` (with masks applied in between).

    Returns (..., n_frames*hop + fft_size - hop) audio; a mask-of-ones round
    trip reproduces the input at unity gain (Executable/stftFix.c:496-579).
    """
    frames = jnp.fft.irfft(spec, n=cfg.fft_size, axis=-1) * synthesis_window(cfg)
    return overlap_add(frames, cfg)


def offline_pad_sizes(num_pcm_frames: int, cfg: TransformConfig) -> tuple[int, int]:
    """(preshift, final_size) of the offline driver's zero padding.

    The CLI shifts the input right by FFTSIZE zeros and pads the total to
    `FFTSIZE * ceil(n / FFTSIZE) + 2 * FFTSIZE` (Executable/main.c:762-767);
    separated stems are read back starting at sample FFTSIZE
    (Executable/main.c:806-808).
    """
    n = cfg.fft_size
    readcount = -(-num_pcm_frames // n)
    return n, n * readcount + 2 * n


def pad_offline(x: jax.Array, cfg: TransformConfig) -> jax.Array:
    """Apply the offline driver's preshift/tail padding to (..., n) audio."""
    preshift, final_size = offline_pad_sizes(x.shape[-1], cfg)
    pad = [(0, 0)] * (x.ndim - 1) + [(preshift, final_size - preshift - x.shape[-1])]
    return jnp.pad(x, pad)
