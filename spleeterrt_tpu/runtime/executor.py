"""Chunked offline executor for arbitrarily long tracks.

The reference's offline driver materializes the entire track's spectrogram
in RAM (4 planes x frames x FFTSIZE floats, Executable/stftFix.c:367-371) --
fine for songs, not for hours of audio on an accelerator with fixed HBM.
This executor processes fixed-size chunks (whole numbers of timeStep tiles)
under one compiled step, carrying nothing between chunks: each chunk reads
an analysis lookahead of FFTSIZE - HOP samples past its end and returns an
overlap-add tail the host accumulates into the next chunk's head (the same
halo algebra as parallel/timeshard.py, sequential instead of SPMD).

JAX's async dispatch double-buffers automatically: the host slices and
uploads chunk k+1 while the device computes chunk k -- the functional
equivalent of the reference's boss/worker overlap (Executable/main.c:444-674).
Output is bit-identical to the monolithic graph because tile boundaries and
frame zeroing use global frame indices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spleeterrt_tpu.config import STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu.core import transform
from spleeterrt_tpu.core.model import Params, multi_stem_forward

RT_OUT_BAND = (0.25, 0.0, 0.25, 0.25)


@functools.partial(
    jax.jit, static_argnames=("cfg", "n_frames_chunk", "out_band")
)
def _chunk_step(
    stacked_params: Params,
    ext: jax.Array,  # (2, n_frames_chunk * hop + (fft - hop)) with lookahead
    frame_offset: jax.Array,  # global index of this chunk's first frame
    n_comp: jax.Array,  # global computed-frame count
    cfg: SeparatorConfig,
    n_frames_chunk: int,
    out_band: tuple[float, ...] = RT_OUT_BAND,
) -> jax.Array:
    tcfg = cfg.transform
    hop, fft, lap = tcfg.hop, tcfg.fft_size, tcfg.overlap
    wa = transform.analysis_window(fft)
    ws = transform.synthesis_window(tcfg)
    bl, t = cfg.bin_limit, cfg.time_step

    blocks = ext.reshape(2, n_frames_chunk + lap - 1, hop)
    frames = jnp.concatenate(
        [blocks[:, k : k + n_frames_chunk] for k in range(lap)], axis=-1
    )
    gframe = frame_offset + jnp.arange(n_frames_chunk)
    frames = jnp.where((gframe < n_comp)[None, :, None], frames, 0.0)
    spec = jnp.fft.rfft(frames * wa, axis=-1)

    nt = n_frames_chunk // t
    tiles = jnp.abs(spec[..., :bl]).reshape(2, nt, t, bl).transpose(1, 2, 3, 0)
    masks = multi_stem_forward(
        stacked_params, tiles, STEM_MODE_4, cfg.compute_dtype, cfg.sigmoid
    )
    n_stems = masks.shape[0]
    masks = masks.transpose(0, 4, 1, 2, 3).reshape(n_stems, 2, n_frames_chunk, bl)
    uw = jnp.asarray(out_band[:n_stems], jnp.float32)

    masked = jnp.concatenate(
        [
            spec[None, ..., :bl] * masks.astype(spec.real.dtype),
            spec[None, ..., bl:] * uw[:, None, None, None].astype(spec.real.dtype),
        ],
        axis=-1,
    )
    frames_t = jnp.fft.irfft(masked, n=fft, axis=-1) * ws
    chunks4 = frames_t.reshape(n_stems, 2, n_frames_chunk, lap, hop)
    nb = n_frames_chunk + lap - 1
    y = jnp.zeros((n_stems, 2, nb, hop), frames_t.dtype)
    for c in range(lap):
        y = y.at[:, :, c : c + n_frames_chunk].add(chunks4[:, :, :, c])
    return y.reshape(n_stems, 2, nb * hop)  # chunk + (fft - hop) tail


def separate_4stem_chunked(
    stacked_params: Params,
    audio: np.ndarray,  # (2, n) raw audio
    cfg: SeparatorConfig,
    chunk_tiles: int = 8,
    out_band: tuple[float, ...] = RT_OUT_BAND,
) -> np.ndarray:
    """Bounded-memory 4-stem separation; equals the monolithic graph.

    `chunk_tiles` timeStep-tiles per device step (peak activation memory is
    proportional to it). Returns (4, 2, n).
    """
    tcfg = cfg.transform
    hop, fft = tcfg.hop, tcfg.fft_size
    halo = fft - hop
    n = audio.shape[-1]
    preshift, final_size = transform.offline_pad_sizes(n, cfg.transform)
    n_comp = transform.num_computed_frames(final_size, tcfg)

    n_frames_chunk = chunk_tiles * cfg.time_step
    chunk_len = n_frames_chunk * hop
    total_frames = -(-final_size // hop)
    n_chunks = -(-total_frames // n_frames_chunk)

    padded = np.zeros((2, n_chunks * chunk_len + halo), np.float32)
    padded[:, preshift : preshift + n] = np.asarray(audio, np.float32)[:, :n]

    out = np.zeros((4, 2, n_chunks * chunk_len + halo), np.float32)
    pending = []  # (chunk_index, device_result) for async overlap
    for k in range(n_chunks):
        ext = jnp.asarray(padded[:, k * chunk_len : k * chunk_len + chunk_len + halo])
        y = _chunk_step(
            stacked_params, ext, jnp.int32(k * n_frames_chunk),
            jnp.int32(n_comp), cfg, n_frames_chunk, out_band,
        )
        pending.append((k, y))
        # Drain with one chunk in flight: device computes k while the host
        # accumulates k-1 (async dispatch keeps the pipe full).
        if len(pending) > 1:
            kk, yy = pending.pop(0)
            out[:, :, kk * chunk_len : kk * chunk_len + chunk_len + halo] += (
                np.asarray(yy)
            )
    for kk, yy in pending:
        out[:, :, kk * chunk_len : kk * chunk_len + chunk_len + halo] += np.asarray(yy)
    return out[:, :, preshift : preshift + n]
