"""The jit-compiled separation pipeline and stem graphs.

Reference: the offline frame-block driver `processMT`
(Executable/main.c:444-674) and the stem arithmetic in `main`
(Executable/main.c:779-970). The C code tiles the spectrogram into
`timeStep`-frame windows and distributes contiguous tile ranges over worker
threads, each owning a full U-Net replica; here every tile is one row of a
batch axis and a single forward pass covers all tiles (and, via vmap, all
stems).

Scale conventions: with core/transform.py's windows, `abs(stft(x))` already
equals the `hypotf(re, im) * FFTSIZE` magnitude the C driver computes
(Executable/main.c:468), and masks multiply the complex spectrogram exactly
as the in-place `re *= mask; im *= mask` loops (Executable/main.c:473-494).
Bins >= bin_limit are scaled by `unaffected_weight` (0.1 offline,
Executable/main.c:773).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from spleeterrt_tpu.config import STEM_MODE_2, STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu.core import transform
from spleeterrt_tpu.core.model import Params, multi_stem_forward, unet_forward


def num_tiles(n_frames: int, time_step: int) -> int:
    """ceil; the reference always runs one (possibly zero-padded) tail tile
    (Executable/main.c:496-537)."""
    return max(1, -(-n_frames // time_step))


def spec_to_tiles(spec: jax.Array, cfg: SeparatorConfig) -> jax.Array:
    """(2, n_frames, n_bins) complex -> magnitude tiles (n_tiles, T, binL, 2).

    Tail frames are zero-padded to a full tile (Executable/main.c:507-514).
    """
    n_frames = spec.shape[-2]
    t = cfg.time_step
    nt = num_tiles(n_frames, t)
    mag = jnp.abs(spec[..., : cfg.bin_limit])
    mag = jnp.pad(mag, ((0, 0), (0, nt * t - n_frames), (0, 0)))
    # (2, nt, T, F) -> (nt, T, F, 2): NHWC with channels on the lane dim.
    return mag.reshape(2, nt, t, cfg.bin_limit).transpose(1, 2, 3, 0)


def tiles_to_frames(tiles: jax.Array, n_frames: int) -> jax.Array:
    """(n_tiles, T, F, 2) -> (2, n_frames, F), dropping tail padding."""
    nt, t, f, _ = tiles.shape
    return tiles.transpose(3, 0, 1, 2).reshape(2, nt * t, f)[:, :n_frames]


def apply_mask(
    spec: jax.Array, mask_frames: jax.Array, cfg: SeparatorConfig,
    unaffected_weight: float | None = None,
) -> jax.Array:
    """Multiply complex spec by a per-bin real mask; out-of-band bins get
    `unaffected_weight` (Executable/main.c:473-494)."""
    uw = cfg.unaffected_weight if unaffected_weight is None else unaffected_weight
    in_band = spec[..., : cfg.bin_limit] * mask_frames.astype(spec.real.dtype)
    out_band = spec[..., cfg.bin_limit :] * jnp.asarray(uw, spec.real.dtype)
    return jnp.concatenate([in_band, out_band], axis=-1)


def compute_masks(
    params: Params, spec: jax.Array, cfg: SeparatorConfig, stem_mode: int,
) -> jax.Array:
    """Single-net masks for every frame: (2, n_frames, bin_limit)."""
    tiles = spec_to_tiles(spec, cfg)
    masks = unet_forward(params, tiles, stem_mode, cfg.compute_dtype, cfg.sigmoid)
    return tiles_to_frames(masks, spec.shape[-2])


def compute_masks_multi(
    stacked_params: Params, spec: jax.Array, cfg: SeparatorConfig, stem_mode: int,
) -> jax.Array:
    """S stacked nets -> (S, 2, n_frames, bin_limit) in one batched pass."""
    tiles = spec_to_tiles(spec, cfg)
    masks = multi_stem_forward(
        stacked_params, tiles, stem_mode, cfg.compute_dtype, cfg.sigmoid
    )
    return jax.vmap(tiles_to_frames, in_axes=(0, None))(masks, spec.shape[-2])


# ---------------------------------------------------------------------------
# Offline stem graphs. All take pre-padded audio (2, final_size) (see
# transform.pad_offline) and return stems (n_stems, 2, out_len) where
# out_len >= final_size; callers crop [preshift : preshift + n_pcm_frames]
# (Executable/main.c:806-808).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg",))
def separate_2stem(
    params: Params, audio: jax.Array, cfg: SeparatorConfig
) -> jax.Array:
    """vocals = istft(mask * spec); accompaniment = input - vocals in the time
    domain (Executable/main.c:779-808). Returns (2, 2ch, out_len)."""
    data_size = audio.shape[-1]
    spec = transform.stft(audio, cfg.transform, data_size)
    masks = compute_masks(params, spec, cfg, STEM_MODE_2)
    vocal = transform.istft(apply_mask(spec, masks, cfg), cfg.transform)
    pad = vocal.shape[-1] - data_size
    residual = jnp.pad(audio, ((0, 0), (0, pad))) - vocal
    return jnp.stack([vocal, residual])


@functools.partial(jax.jit, static_argnames=("cfg",))
def separate_3stem(
    params4: Params, params2: Params, audio: jax.Array, cfg: SeparatorConfig
) -> jax.Array:
    """Two-pass graph (Executable/main.c:845-970): pass 1 (4-stem-family net,
    ELU) masks drums; the FREQUENCY-domain residual feeds pass 2 (2-stem net)
    for vocals; accompaniment = istft(residual) - vocals in time.
    Returns (3, 2ch, out_len) ordered (drums, vocals, accompaniment)."""
    data_size = audio.shape[-1]
    spec = transform.stft(audio, cfg.transform, data_size)
    drum_masks = compute_masks(params4, spec, cfg, STEM_MODE_4)
    drum_spec = apply_mask(spec, drum_masks, cfg)
    residual_spec = spec - drum_spec
    drums = transform.istft(drum_spec, cfg.transform)
    vocal_masks = compute_masks(params2, residual_spec, cfg, STEM_MODE_2)
    vocals = transform.istft(
        apply_mask(residual_spec, vocal_masks, cfg), cfg.transform
    )
    accompaniment = transform.istft(residual_spec, cfg.transform) - vocals
    return jnp.stack([drums, vocals, accompaniment])


# Out-of-band weights per stem family: the RT engine fixes 0.25 for every
# stem except bass at 0.0 (VST/Source/Spleeter4Stems.c:73,281).
OUT_BAND_4 = (0.25, 0.0, 0.25, 0.25)  # drums, bass, accompaniment, vocals
OUT_BAND_5 = (0.25, 0.25, 0.0, 0.25, 0.25)  # vocals, drums, bass, piano, other


@functools.partial(jax.jit, static_argnames=("cfg", "out_band"))
def separate_nstem(
    stacked_params: Params,
    audio: jax.Array,
    cfg: SeparatorConfig,
    out_band: tuple[float, ...],
) -> jax.Array:
    """S independent nets over the same input, one mask per stem -- the VST
    engine's graph (VST/Source/Spleeter4Stems.c:114-147) run offline,
    generalized to any stem count (e.g. upstream Spleeter's 5stems family).
    Returns (S, 2ch, out_len).
    """
    data_size = audio.shape[-1]
    spec = transform.stft(audio, cfg.transform, data_size)
    masks = compute_masks_multi(stacked_params, spec, cfg, STEM_MODE_4)
    uw = jnp.asarray(out_band)

    # vmap over stems; uw enters as a traced scalar per stem.
    def one(mask, w):
        in_band = spec[..., : cfg.bin_limit] * mask.astype(spec.real.dtype)
        oob = spec[..., cfg.bin_limit :] * w.astype(spec.real.dtype)
        return transform.istft(
            jnp.concatenate([in_band, oob], axis=-1), cfg.transform
        )

    return jax.vmap(one)(masks, uw)


# Batched multi-track graphs: (B, 2, n) equal-length pre-padded tracks ->
# (B, S, 2ch, out_len), each track exactly its single-track graph.


@functools.partial(jax.jit, static_argnames=("cfg", "out_band"))
def separate_nstem_batch(
    stacked_params: Params,
    tracks: jax.Array,
    cfg: SeparatorConfig,
    out_band: tuple[float, ...],
) -> jax.Array:
    """Batched N-stem graph -> (B, S, 2ch, out_len)."""
    return jax.vmap(
        lambda a: separate_nstem(stacked_params, a, cfg, out_band)
    )(tracks)


@functools.partial(jax.jit, static_argnames=("cfg",))
def separate_2stem_batch(
    params: Params,  # single net, NO leading stem axis
    tracks: jax.Array,
    cfg: SeparatorConfig,
) -> jax.Array:
    """Batched single-net 2-stem graph -> (B, 2 stems, 2ch, out_len), the
    reference's offline 2-stem semantics per track
    (Executable/main.c:773,779-808)."""
    return jax.vmap(lambda a: separate_2stem(params, a, cfg))(tracks)


@functools.partial(jax.jit, static_argnames=("cfg",))
def separate_3stem_batch(
    params4: Params,
    params2: Params,
    tracks: jax.Array,
    cfg: SeparatorConfig,
) -> jax.Array:
    """Batched two-pass 3-stem graph -> (B, 3, 2ch, out_len) ordered
    (drums, vocals, accompaniment), Executable/main.c:845-970 per track."""
    return jax.vmap(lambda a: separate_3stem(params4, params2, a, cfg))(tracks)


def separate_4stem(
    stacked_params: Params, audio: jax.Array, cfg: SeparatorConfig
) -> jax.Array:
    """4-stem graph ordered (drums, bass, accompaniment, vocals)."""
    return separate_nstem(stacked_params, audio, cfg, OUT_BAND_4)


def separate(
    audio,
    *,
    params: Params | None = None,
    params4: Params | None = None,
    params2: Params | None = None,
    stacked_params: Params | None = None,
    cfg: SeparatorConfig,
) -> dict[str, jax.Array]:
    """High-level entry: pad, run the stem graph for cfg.num_stems, crop.

    `audio` is (2, n) float32 at 44.1 kHz. Returns {stem_name: (2, n)}.
    """
    audio = jnp.asarray(audio, jnp.float32)
    if audio.ndim == 1:
        audio = jnp.stack([audio, audio])
    n = audio.shape[-1]
    preshift, _ = transform.offline_pad_sizes(n, cfg.transform)
    padded = transform.pad_offline(audio, cfg.transform)
    if cfg.num_stems == 2:
        stems = separate_2stem(params, padded, cfg)
    elif cfg.num_stems == 3:
        stems = separate_3stem(params4, params2, padded, cfg)
    elif cfg.num_stems == 4:
        stems = separate_4stem(stacked_params, padded, cfg)
    else:
        stems = separate_nstem(stacked_params, padded, cfg, OUT_BAND_5)
    cropped = stems[..., preshift : preshift + n]
    return dict(zip(cfg.stem_names, cropped))
