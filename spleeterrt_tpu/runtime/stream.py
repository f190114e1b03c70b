"""Streaming (real-time) separation engine.

Re-design of the VST double-buffered engine (VST/Source/Spleeter4Stems.c) as
a functional block-level pipeline:

- Asymmetric analysis/synthesis window pair built by `getAsymmetricWindow`
  (VST/Source/Spleeter4Stems.c:383-401) with SAMPLESHIFT = FFTSIZE -
  2*OVPSIZE: the synthesis window lives in the most recent 2*hop samples of
  each frame, trading spectral-analysis centering for low latency.
- Per hop (OUTPUTSEG = 1024 samples): forward transform of the newest
  FFTSIZE input samples; synthesis of one output hop from the stored
  spectrum at the same cursor of the CURRENT double buffer, read before it
  is overwritten (Spleeter4Stems.c:257-349).
- Per block (timeStep hops): buffer swap + background NN kick
  (Spleeter4Stems.c:350-377). Because the spectrogram buffer index
  alternates per block and each slot is read before being rewritten, the
  spectra synthesized during block B were captured during block B-2, and
  the masks applied to them (joined at the end of block B-1 from threads
  started at the end of block B-2) were computed from block B-2's own
  magnitudes: masks are MATCHED to their spectra, and output audio lags
  input by exactly two timeStep blocks plus one hop. (Verified hop-by-hop
  against the literal engine port in tests/oracle/streaming_oracle.py;
  the README's latency prose undercounts this by one block.)

  Since the masks are a deterministic function of the stored spectra
  (mag = |spec| below bin_limit), the functional carry needs only the last
  two blocks' spectra; masks for the outgoing block are recomputed from the
  carried spectra exactly when the C engine's threads would produce them.

The C engine interleaves these with 5 pthreads; here the entire block is one
jitted step: batched rFFT over all hops, batched masked synthesis, one batched
U-Net call -- and `lax.scan` chains blocks for offline streaming simulation.
The scale chain collapses exactly as in core/transform.py: with the raw
asymmetric windows, magnitude = |rfft(frame * w_a)| matches the C engine's
`hypotf * FFTSIZE` (Spleeter4Stems.c:327-343 with the 1/N * 0.5 analysis
scale), and the synthesized frame is plain irfft of the masked spectrum.

Out-of-band bins (>= bin_limit) use the engine's fixed masks: 0.25 for
drums/accompaniment/vocals, 0.0 for bass (Spleeter4Stems.c:73,281).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from spleeterrt_tpu.config import STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu.core.model import Params, multi_stem_forward

# Fixed engine geometry (VST/Source/Spleeter4Stems.h:1-13).
FFT_SIZE = 4096
OVP_SIZE = 1024  # analysis overlap quantum
HOP = OVP_SIZE  # OUTPUTSEG
SAMPLE_SHIFT = FFT_SIZE - 2 * OVP_SIZE  # 2048
SYNTH_LEN = FFT_SIZE - SAMPLE_SHIFT  # 2048: active synthesis region
N_BINS = FFT_SIZE // 2 + 1

RT_OUT_BAND = (0.25, 0.0, 0.25, 0.25)  # drums, bass, accompaniment, vocals


def asymmetric_windows(
    freq_temporal: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """(analysis[FFT_SIZE], synthesis_eff[SYNTH_LEN]).

    Port of the construction at VST/Source/Spleeter4Stems.c:383-401 with
    k = FFT_SIZE, m = OVP_SIZE. `synthesis_eff[j]` multiplies frame sample
    SAMPLE_SHIFT + j (the pre-shift is folded in).

    `freq_temporal` is the reference's frequency-vs-temporal-resolution
    exponent (the README's "even shorter intrinsical latency" knob): > 1
    sharpens the analysis window's recent-samples emphasis (better
    temporal locality, coarser spectrum), < 1 the reverse. The reference
    clamps the exponent to 2.0 for the rising tail section
    (Spleeter4Stems.c:391-394), and the synthesis window divides by the
    analysis window, so perfect COLA reconstruction holds for every value.
    """
    k, m = FFT_SIZE, OVP_SIZE
    wa = np.zeros(k)
    n1 = 2 * (k - m) + 2
    i = np.arange(k - m)
    wa[: k - m] = (
        0.5 * (1.0 - np.cos(2.0 * np.pi * (i + 1.0) / n1))
    ) ** freq_temporal
    ft2 = min(freq_temporal, 2.0)  # Spleeter4Stems.c:391-392
    n2 = 2 * m + 2
    j = np.arange(k - m, k)
    wa[k - m :] = np.sqrt(
        0.5 * (1.0 - np.cos(2.0 * np.pi * ((m + j - (k - m)) + 1.0) / n2))
    ) ** ft2
    n3 = 2 * m
    ws = np.zeros(k)
    i = np.arange(k - 2 * m, k)
    ws[k - 2 * m :] = (
        0.5 * (1.0 - np.cos(2.0 * np.pi * (i - (k - 2 * m)) / n3))
    ) / wa[k - 2 * m :]
    return wa, ws[SAMPLE_SHIFT:]


class StreamState(NamedTuple):
    """Scan carry for the block engine (all shapes static)."""

    in_tail: jax.Array  # (2, FFT_SIZE - HOP) last input samples
    spec1: jax.Array  # (2, T, N_BINS) complex: block B-1 spectra
    spec2: jax.Array  # (2, T, N_BINS) complex: block B-2 spectra
    masks2: jax.Array  # (S, T, bin_limit, 2): masks for spec2
    ola_tail: jax.Array  # (S, 2, HOP) overlap-add tail across blocks


def init_state(cfg: SeparatorConfig, n_stems: int) -> StreamState:
    t = cfg.time_step
    zspec = jnp.zeros((2, t, N_BINS), jnp.complex64)
    return StreamState(
        in_tail=jnp.zeros((2, FFT_SIZE - HOP), jnp.float32),
        spec1=zspec,
        spec2=zspec,
        # The C engine initializes the mask double-buffers to 1.0
        # (pass-through until the first inference, Spleeter4Stems.c:456-467).
        masks2=jnp.ones((n_stems, t, cfg.bin_limit, 2), jnp.float32),
        ola_tail=jnp.zeros((n_stems, 2, HOP), jnp.float32),
    )


def init_state_streams(
    cfg: SeparatorConfig, n_stems: int, n_streams: int
) -> StreamState:
    """Scan carry for `block_step_streams`: leading stream axis on every leaf."""
    one = init_state(cfg, n_stems)
    return jax.tree.map(
        lambda a: jnp.broadcast_to(a, (n_streams,) + a.shape), one
    )


def _block_step_streams_impl(
    stacked_params: Params,
    state: StreamState,  # leaves carry a leading stream axis K
    block_in: jax.Array,  # (K, 2, T * HOP)
    cfg: SeparatorConfig,
    n_stems: int,
    uw: jax.Array,  # (S,) out-of-band weights (traced: shard_map bodies
    # pass their per-device stem slice, parallel/mesh.py)
    freq_temporal: float,
):
    """Un-jitted body of `block_step_streams`; see its docstring."""
    t = cfg.time_step
    k_streams = block_in.shape[0]
    wa, ws = asymmetric_windows(freq_temporal)
    wa = jnp.asarray(wa, jnp.float32)
    ws = jnp.asarray(ws, jnp.float32)

    # --- Synthesis of this block's output from the carry ------------------
    bl = cfg.bin_limit
    # masks (K, S, T, bl, 2) -> (K, S, 2, T, bl) aligning with spec.
    m_in = state.masks2.transpose(0, 1, 4, 2, 3)
    spec = state.spec2[:, None]  # (K, 1, 2, T, bins)
    masked_in = spec[..., :bl] * m_in.astype(jnp.complex64)
    masked_out = spec[..., bl:] * uw[:, None, None, None].astype(jnp.complex64)
    masked = jnp.concatenate([masked_in, masked_out], axis=-1)
    frames_t = jnp.fft.irfft(masked, n=FFT_SIZE, axis=-1)  # (K,S,2,T,FFT)
    tails = frames_t[..., SAMPLE_SHIFT:] * ws  # (K,S,2,T,SYNTH_LEN)
    # out hop c = tails[c][:HOP] + tails[c-1][HOP:], c-1 = -1 from carry.
    heads = tails[..., :HOP]
    prevs = jnp.concatenate(
        [state.ola_tail[:, :, :, None, :], tails[..., :-1, HOP:]], axis=3
    )
    out_block = (heads + prevs).reshape(k_streams, n_stems, 2, t * HOP)

    # --- Analysis of the incoming block -----------------------------------
    ext = jnp.concatenate([state.in_tail, block_in], axis=-1)
    # frame c = ext[c*HOP : c*HOP + FFT_SIZE]; HOP divides FFT_SIZE -> use
    # the shifted-reshape framing (4 concatenated block views).
    n_blocks_r = t + (FFT_SIZE // HOP) - 1
    blocks = ext.reshape(k_streams, 2, n_blocks_r, HOP)
    frames = jnp.concatenate(
        [blocks[:, :, k : k + t, :] for k in range(FFT_SIZE // HOP)], axis=-1
    )
    spec_cur = jnp.fft.rfft(frames * wa, axis=-1)  # (K, 2, T, N_BINS)

    # Masks for the block now entering the spec2 slot: computed from ITS OWN
    # magnitudes, exactly what the C engine's background threads (started at
    # that block's boundary, joined one block later) produce. All K streams'
    # tiles batch through one multi-stem U-Net call.
    mag = jnp.abs(state.spec1[..., :bl])  # (K, 2, T, bl)
    nn_in = mag.transpose(0, 2, 3, 1)  # (K, T, bl, 2)
    masks_new = multi_stem_forward(
        stacked_params, nn_in, STEM_MODE_4, cfg.compute_dtype, cfg.sigmoid
    ).transpose(1, 0, 2, 3, 4)  # (K, S, T, bl, 2)

    new_state = StreamState(
        in_tail=ext[:, :, -(FFT_SIZE - HOP) :],
        spec1=spec_cur,
        spec2=state.spec1,
        masks2=masks_new,
        ola_tail=tails[..., -1, HOP:],
    )
    return new_state, out_block


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_stems", "out_band", "freq_temporal"),
)
def block_step_streams(
    stacked_params: Params,
    state: StreamState,  # leaves carry a leading stream axis K
    block_in: jax.Array,  # (K, 2, T * HOP)
    cfg: SeparatorConfig,
    n_stems: int = 4,
    out_band: tuple[float, ...] = RT_OUT_BAND,
    freq_temporal: float = 1.0,
):
    """One timeStep block of K concurrent independent streams.

    Returns (new_state, out_block (K, S, 2, T * HOP)). Batching K streams
    into one dispatch is the accelerator's serving shape: the per-block
    U-Net call batches K tiles x S stems instead of a single tile (the
    reference serves one stream per plugin instance,
    VST/Source/Spleeter4Stems.c:512-582; one card replaces a rack of them).
    Stream k's output is sample-exact equal to running it alone.
    """
    return _block_step_streams_impl(
        stacked_params, state, block_in, cfg, n_stems,
        jnp.asarray(out_band, jnp.float32), freq_temporal,
    )


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_stems", "out_band", "freq_temporal"),
)
def block_step(
    stacked_params: Params,
    state: StreamState,
    block_in: jax.Array,  # (2, T * HOP)
    cfg: SeparatorConfig,
    n_stems: int = 4,
    out_band: tuple[float, ...] = RT_OUT_BAND,
    freq_temporal: float = 1.0,
):
    """One timeStep block: returns (new_state, out_block (S, 2, T * HOP)).

    `out_block` is the audio played WHILE `block_in` arrives; it depends only
    on the carry (previous blocks), preserving the C engine's causality and
    two-block latency. Single-stream wrapper of `block_step_streams`.
    """
    state1 = jax.tree.map(lambda a: a[None], state)
    new_state, out = block_step_streams(
        stacked_params, state1, block_in[None], cfg, n_stems, out_band,
        freq_temporal,
    )
    return jax.tree.map(lambda a: a[0], new_state), out[0]


def _stream_scan_impl(
    stacked_params: Params,
    audio: jax.Array,  # (2, n_blocks * T * HOP)
    cfg: SeparatorConfig,
    n_stems: int,
    uw: jax.Array,  # (S,) out-of-band weights
    freq_temporal: float,
):
    """Un-jitted scan over blocks; see `stream_scan`. `uw` is traced so a
    shard_map body can run its local stem group (parallel/mesh.py)."""
    t = cfg.time_step
    n = audio.shape[-1]
    n_blocks = n // (t * HOP)
    blocks = audio[:, : n_blocks * t * HOP].reshape(2, n_blocks, t * HOP)
    blocks = blocks.transpose(1, 0, 2)  # (n_blocks, 2, T*HOP)

    def step(state, block_in):
        state1 = jax.tree.map(lambda a: a[None], state)
        new_state, out = _block_step_streams_impl(
            stacked_params, state1, block_in[None], cfg, n_stems, uw,
            freq_temporal,
        )
        return jax.tree.map(lambda a: a[0], new_state), out[0]

    state = init_state(cfg, n_stems)
    _, outs = jax.lax.scan(step, state, blocks)  # (n_blocks, S, 2, T*HOP)
    return outs.transpose(1, 2, 0, 3).reshape(n_stems, 2, n_blocks * t * HOP)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_stems", "out_band", "freq_temporal"),
)
def stream_scan(
    stacked_params: Params,
    audio: jax.Array,  # (2, n_blocks * T * HOP)
    cfg: SeparatorConfig,
    n_stems: int = 4,
    out_band: tuple[float, ...] = RT_OUT_BAND,
    freq_temporal: float = 1.0,
):
    """Run the whole signal through the streaming engine with lax.scan.

    Returns (S, 2, n) where n = audio length; output sample t corresponds to
    input around t - (2 * time_step + 1) * HOP (two blocks + one hop of
    intrinsic latency; see the module docstring).
    """
    return _stream_scan_impl(
        stacked_params, audio, cfg, n_stems,
        jnp.asarray(out_band, jnp.float32), freq_temporal,
    )


class StreamingSeparator:
    """Sample-granular push API mirroring `Spleeter4StemsProcessSamples`
    (VST/Source/Spleeter4Stems.c:512-582): feed arbitrary chunk sizes, get
    the same number of output samples per stem back, with the engine's
    intrinsic latency. Host-side ring buffering; all DSP in jitted steps.
    """

    def __init__(
        self,
        stacked_params: Params,
        cfg: SeparatorConfig,
        n_stems: int = 4,
        out_band: tuple[float, ...] = RT_OUT_BAND,
        freq_temporal: float = 1.0,
    ):
        self.params = stacked_params
        self.cfg = cfg
        self.n_stems = n_stems
        self.out_band = out_band
        self.freq_temporal = freq_temporal
        self.state = init_state(cfg, n_stems)
        self.block_len = cfg.time_step * HOP
        self._in_buf = np.zeros((2, 0), np.float32)
        # Output played during the first block: silence (zero spec_prev).
        self._out_buf = np.zeros((n_stems, 2, self.block_len), np.float32)
        self._out_pos = 0

    def process(self, chunk: np.ndarray) -> np.ndarray:
        """(2, n) in -> (S, 2, n) out (delayed by the engine latency)."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim == 1:
            chunk = np.stack([chunk, chunk])
        n = chunk.shape[-1]
        self._in_buf = np.concatenate([self._in_buf, chunk], axis=-1)
        out = np.zeros((self.n_stems, 2, n), np.float32)
        produced = 0
        while produced < n:
            avail = self._out_buf.shape[-1] - self._out_pos
            if avail == 0:
                if self._in_buf.shape[-1] < self.block_len:
                    break  # need more input before the next block exists
                block = jnp.asarray(self._in_buf[:, : self.block_len])
                self._in_buf = self._in_buf[:, self.block_len :]
                self.state, out_block = block_step(
                    self.params, self.state, block, self.cfg,
                    self.n_stems, self.out_band,
                    freq_temporal=self.freq_temporal,
                )
                self._out_buf = np.asarray(out_block)
                self._out_pos = 0
                avail = self._out_buf.shape[-1]
            take = min(avail, n - produced)
            out[..., produced : produced + take] = self._out_buf[
                ..., self._out_pos : self._out_pos + take
            ]
            self._out_pos += take
            produced += take
        return out
