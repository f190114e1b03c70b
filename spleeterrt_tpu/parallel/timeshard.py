"""Sequence-parallel separation: the signal axis sharded across the mesh.

This is the SPMD mapping of the reference's frame-level data parallelism
(STFT frames split into contiguous sample ranges per worker,
Executable/stftFix.c:379-427, and timeStep-tile ranges per thread,
Executable/main.c:550-575) -- but instead of shared-memory arrays, each
device owns a contiguous audio chunk end-to-end (STFT -> U-Net masks ->
iSTFT) and exchanges only the transform halos with its ring neighbors:

- analysis halo: each frame needs FFTSIZE - HOP = 3072 samples beyond the
  chunk edge -> one `ppermute` shifting each chunk's head to its left
  neighbor before framing;
- synthesis halo: local overlap-add produces FFTSIZE - HOP samples past the
  chunk edge -> one `ppermute` shifting the tail to the right neighbor,
  added into its head.

Nothing else crosses devices: spectrogram tiles are independent by design
(no cross-tile context in the reference), and the per-stem U-Nets are
replicated. Two collective-permutes per separation, total traffic
2 * 3072 samples per device boundary, regardless of track length.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spleeterrt_tpu.config import STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu.core import transform
from spleeterrt_tpu.core.model import Params, multi_stem_forward


def padded_length(n: int, cfg: SeparatorConfig, n_devices: int) -> int:
    """Smallest length >= n divisible by n_devices * time_step * hop so each
    device holds a whole number of spectrogram tiles."""
    quantum = n_devices * cfg.time_step * cfg.transform.hop
    return -(-n // quantum) * quantum


def separate_4stem_timesharded(
    stacked_params: Params,
    audio: jax.Array,  # (2, n_pad): pre-padded, n_pad from padded_length
    cfg: SeparatorConfig,
    mesh: Mesh,
    data_size: int,
    out_band: tuple[float, ...] = (0.25, 0.0, 0.25, 0.25),
) -> jax.Array:
    """4-stem masked separation with the sample axis sharded over "data".

    `data_size` is the semantic signal length (frames past the reference's
    computed range stay zero, Executable/stftFix.c:460-495); the trailing
    sharding pad beyond it only adds zero frames. Returns (4, 2, n_pad),
    sharded on the last axis; stems match the replicated separate_4stem on
    [0, data_size + fft - hop) when audio was padded with pad_offline first.
    """
    tcfg = cfg.transform
    hop, fft = tcfg.hop, tcfg.fft_size
    halo = fft - hop
    n_pad = audio.shape[-1]
    n_dev = mesh.shape["data"]
    chunk = n_pad // n_dev
    frames_per_dev = chunk // hop
    if chunk * n_dev != n_pad or frames_per_dev % cfg.time_step:
        raise ValueError("pad audio with padded_length() first")
    n_comp = transform.num_computed_frames(data_size, tcfg)
    axis = "data"

    wa = transform.analysis_window(fft)
    ws = transform.synthesis_window(tcfg)
    uw = jnp.asarray(out_band, jnp.float32)

    def local(params, chunk_audio):
        # chunk_audio: (2, chunk). Analysis halo from the right neighbor.
        d = jax.lax.axis_index(axis)
        head = chunk_audio[:, :halo]
        halo_r = jax.lax.ppermute(
            head, axis, [(i, i - 1) for i in range(1, n_dev)]
        )  # device d receives device d+1's head; last device gets zeros
        ext = jnp.concatenate([chunk_audio, halo_r], axis=-1)

        blocks = ext.reshape(2, frames_per_dev + tcfg.overlap - 1, hop)
        frames = jnp.concatenate(
            [blocks[:, k : k + frames_per_dev] for k in range(tcfg.overlap)],
            axis=-1,
        )
        # Zero frames at/after the reference's computed range.
        gframe = d * frames_per_dev + jnp.arange(frames_per_dev)
        frames = jnp.where((gframe < n_comp)[None, :, None], frames, 0.0)
        spec = jnp.fft.rfft(frames * wa, axis=-1)  # (2, F_local, bins)

        # Local tiles -> multi-stem U-Net (params replicated).
        bl, t = cfg.bin_limit, cfg.time_step
        nt = frames_per_dev // t
        mag = jnp.abs(spec[..., :bl]).reshape(2, nt, t, bl)
        tiles = mag.transpose(1, 2, 3, 0)  # (nt, T, bl, 2)
        masks = multi_stem_forward(
            params, tiles, STEM_MODE_4, cfg.compute_dtype, cfg.sigmoid
        )  # (S, nt, T, bl, 2)
        masks = masks.transpose(0, 4, 1, 2, 3).reshape(4, 2, frames_per_dev, bl)

        masked_in = spec[None, ..., :bl] * masks.astype(spec.real.dtype)
        masked_out = spec[None, ..., bl:] * uw[:, None, None, None].astype(
            spec.real.dtype
        )
        masked = jnp.concatenate([masked_in, masked_out], axis=-1)

        frames_t = jnp.fft.irfft(masked, n=fft, axis=-1) * ws  # (4,2,F,fft)
        # Local overlap-add -> (4, 2, chunk + halo).
        lap = tcfg.overlap
        chunks4 = frames_t.reshape(4, 2, frames_per_dev, lap, hop)
        nb = frames_per_dev + lap - 1
        y = jnp.zeros((4, 2, nb, hop), frames_t.dtype)
        for c in range(lap):
            y = y.at[:, :, c : c + frames_per_dev].add(chunks4[:, :, :, c])
        y = y.reshape(4, 2, nb * hop)

        # Synthesis halo to the right neighbor.
        tail = y[..., chunk:]
        from_left = jax.lax.ppermute(
            tail, axis, [(i, i + 1) for i in range(n_dev - 1)]
        )  # device d receives device d-1's tail; device 0 gets zeros
        return y[..., :chunk].at[..., :halo].add(from_left)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(None, axis)),
        out_specs=P(None, None, axis),
    )
    return fn(stacked_params, audio)


def separate_4stem_timesharded_padded(
    stacked_params: Params,
    audio: jax.Array,  # (2, n) raw audio
    cfg: SeparatorConfig,
    mesh: Mesh,
) -> jax.Array:
    """Convenience wrapper: offline padding + sharding padding + crop.

    Returns (4, 2, n) stems, matching core.separate.separate() cropping
    (Executable/main.c:806-808).
    """
    n = audio.shape[-1]
    preshift, final_size = transform.offline_pad_sizes(n, cfg.transform)
    padded = transform.pad_offline(audio, cfg.transform)
    n_pad = padded_length(final_size, cfg, mesh.shape["data"])
    padded = jnp.pad(padded, ((0, 0), (0, n_pad - final_size)))
    padded = jax.device_put(
        padded, NamedSharding(mesh, P(None, "data"))
    )
    stems = separate_4stem_timesharded(
        stacked_params, padded, cfg, mesh, data_size=final_size
    )
    return stems[..., preshift : preshift + n]
