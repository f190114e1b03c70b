"""Device-mesh sharding for separation and training.

The reference's entire scaling story is pthread pools over shared memory:
spectrogram tiles across threads (Executable/main.c:550-575), STFT frames
across threads (Executable/stftFix.c:379-427), one U-Net replica per stem
thread (VST/Source/Spleeter4Stems.c:135). The mesh equivalents:

- "stem" axis: the 4 per-stem U-Nets are expert-style model parallelism;
  stem-sharded params put one (or more) nets per device group.
- "data" axis: spectrogram tiles (the reference's frame-block data
  parallelism) shard across devices; tiles are independent by design (no
  cross-tile context, SURVEY.md section 2), so mask inference needs no halo.
- STFT/iSTFT stay replicated: they are a small share of the work; the overlap-add halo
  (FFTSIZE - HOP samples) is only needed if the signal axis itself is
  sharded, which the offline path avoids by sharding tiles instead.

All entry points accept any `jax.sharding.Mesh`; tests exercise them on an
8-device virtual CPU mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spleeterrt_tpu.config import STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu.core import transform
from spleeterrt_tpu.core.model import Params, multi_stem_forward
from spleeterrt_tpu.core.separate import spec_to_tiles, tiles_to_frames


def make_mesh(
    devices: list | None = None, stem_parallel: int = 1
) -> Mesh:
    """Mesh over (stem, data). `stem_parallel` devices cooperate per... rather:
    the stem axis has `stem_parallel` groups; remaining devices do data
    parallelism over tiles."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n % stem_parallel:
        raise ValueError(f"{n} devices not divisible by stem_parallel={stem_parallel}")
    arr = np.asarray(devices).reshape(stem_parallel, n // stem_parallel)
    return Mesh(arr, ("stem", "data"))


def shard_params(params: Params, mesh: Mesh, stem_sharded: bool) -> Params:
    """Place params: stacked per-stem params shard their leading stem axis
    over the "stem" mesh axis; everything else is replicated."""
    spec = P("stem") if stem_sharded else P()
    sharding = NamedSharding(mesh, spec)
    return jax.tree.map(lambda a: jax.device_put(a, sharding), params)


def _pad_tiles(tiles: jax.Array, n_shards: int) -> tuple[jax.Array, int]:
    nt = tiles.shape[0]
    padded = -(-nt // n_shards) * n_shards
    if padded != nt:
        tiles = jnp.pad(tiles, ((0, padded - nt),) + ((0, 0),) * (tiles.ndim - 1))
    return tiles, nt


def compute_masks_sharded(
    stacked_params: Params,
    spec: jax.Array,
    cfg: SeparatorConfig,
    mesh: Mesh,
    stem_mode: int = STEM_MODE_4,
) -> jax.Array:
    """Multi-stem masks with tiles sharded over "data" and stems over "stem".

    When the stem count divides the "stem" axis, the forward runs under
    `shard_map`: each device gets its stem group's params and its tile
    shard and computes with no collective. Otherwise GSPMD partitions the
    graph from sharding constraints. Returns (S, 2, n_frames, bin_limit),
    replicated.
    """
    n_data = mesh.shape["data"]
    n_stem = mesh.shape["stem"]
    n_stems = jax.tree.leaves(stacked_params)[0].shape[0]
    tiles = spec_to_tiles(spec, cfg)
    tiles, n_tiles = _pad_tiles(tiles, n_data)

    if n_stems % n_stem == 0:
        fwd = jax.shard_map(
            lambda p, t: multi_stem_forward(
                p, t, stem_mode, cfg.compute_dtype, cfg.sigmoid
            ),
            mesh=mesh,
            in_specs=(P("stem"), P("data")),
            out_specs=P("stem", "data"),
        )
        masks = jax.jit(fwd)(stacked_params, tiles)
    else:
        tiles = jax.lax.with_sharding_constraint(
            tiles, NamedSharding(mesh, P("data"))
        )
        masks = multi_stem_forward(
            stacked_params, tiles, stem_mode, cfg.compute_dtype, cfg.sigmoid
        )
        masks = jax.lax.with_sharding_constraint(
            masks, NamedSharding(mesh, P("stem", "data"))
        )
    masks = masks[:, :n_tiles]
    return jax.vmap(tiles_to_frames, in_axes=(0, None))(masks, spec.shape[-2])


def separate_4stem_sharded(
    stacked_params: Params,
    audio: jax.Array,
    cfg: SeparatorConfig,
    mesh: Mesh,
) -> jax.Array:
    """Mesh-sharded 4-stem offline graph; see core.separate.separate_4stem."""
    data_size = audio.shape[-1]

    def fn(params, audio):
        spec = transform.stft(audio, cfg.transform, data_size)
        masks = compute_masks_sharded(params, spec, cfg, mesh)
        out_band = jnp.asarray([0.25, 0.0, 0.25, 0.25])

        def one(mask, uw):
            in_band = spec[..., : cfg.bin_limit] * mask.astype(spec.real.dtype)
            oob = spec[..., cfg.bin_limit :] * uw.astype(spec.real.dtype)
            return transform.istft(
                jnp.concatenate([in_band, oob], axis=-1), cfg.transform
            )

        return jax.vmap(one)(masks, out_band)

    return jax.jit(fn)(stacked_params, audio)


@functools.lru_cache(maxsize=64)
def make_batch_fn(cfg: SeparatorConfig, mesh: Mesh, n_stems: int):
    """Cached jitted (params, tracks) -> stems for repeated batch dispatch.

    The track batch is `shard_map`ped over the "data" mesh axis (params
    replicated): each device runs the whole pipeline -- STFT, U-Net, masked
    iSTFT -- on its local tracks, with zero cross-device communication
    (tracks are independent).

    A fresh `jax.jit(closure)` per call re-traces every time; serving loops
    must reuse one compiled callable (benchmarks/bench_batch.py measures the
    marginal dispatch rate through this)."""
    from spleeterrt_tpu.core.separate import (
        OUT_BAND_4, OUT_BAND_5, separate_nstem_batch,
    )

    if n_stems not in (4, 5):
        # The per-stem out-of-band weights are a property of the stem
        # FAMILY, not the count: guessing them silently would apply the RT
        # engine's 4-stem weights to e.g. a 2-net batch, where the
        # reference's 2-stem offline graph uses unaffected_weight=0.1 plus
        # a time-domain residual (Executable/main.c:773,794-798) -- that
        # graph is make_batch2_fn / separate_2stem_batch_sharded.
        raise ValueError(
            f"make_batch_fn supports the 4- and 5-stem families, got "
            f"{n_stems} stacked nets; for the single-net 2-stem offline "
            f"graph use make_batch2_fn / separate_2stem_batch_sharded"
        )
    out_band = {4: OUT_BAND_4, 5: OUT_BAND_5}[n_stems]
    n_devices = mesh.devices.size
    flat = Mesh(mesh.devices.reshape(-1), ("data",))

    def local(params, tracks):
        return separate_nstem_batch(params, tracks, cfg, out_band)

    fn = jax.shard_map(
        local, mesh=flat, in_specs=(P(), P("data")), out_specs=P("data")
    )
    return jax.jit(fn), n_devices


@functools.lru_cache(maxsize=64)
def make_batch2_fn(cfg: SeparatorConfig, mesh: Mesh):
    """Cached jitted (params, tracks) -> (B, 2, 2ch, out_len) for the
    single-net 2-stem offline graph (Executable/main.c:779-808), tracks
    shard_mapped over the flattened mesh."""
    from spleeterrt_tpu.core.separate import separate_2stem_batch

    flat = Mesh(mesh.devices.reshape(-1), ("data",))

    def local(params, tracks):
        return separate_2stem_batch(params, tracks, cfg)

    fn = jax.shard_map(
        local, mesh=flat, in_specs=(P(), P("data")), out_specs=P("data")
    )
    return jax.jit(fn), flat.devices.size


def separate_2stem_batch_sharded(
    params: Params,  # single net, NO leading stem axis
    tracks: jax.Array,  # (n_tracks, 2, n) pre-padded to equal length
    cfg: SeparatorConfig,
    mesh: Mesh,
) -> jax.Array:
    """Batched 2-stem separation with tracks sharded over the mesh;
    returns (n_tracks, 2 stems, 2ch, out_len). Track counts not divisible
    by the device count are zero-padded and cropped."""
    fn, n_devices = make_batch2_fn(cfg, mesh)
    n_tracks = tracks.shape[0]
    padded = -(-n_tracks // n_devices) * n_devices
    if padded != n_tracks:
        tracks = jnp.pad(tracks, ((0, padded - n_tracks), (0, 0), (0, 0)))
    return fn(params, tracks)[:n_tracks]


@functools.lru_cache(maxsize=64)
def make_batch3_fn(cfg: SeparatorConfig, mesh: Mesh):
    """Cached jitted (params4, params2, tracks) -> (B, 3, 2ch, out_len)
    for the two-pass 3-stem graph (Executable/main.c:845-970), tracks
    shard_mapped over the flattened mesh."""
    from spleeterrt_tpu.core.separate import separate_3stem_batch

    flat = Mesh(mesh.devices.reshape(-1), ("data",))

    def local(params4, params2, tracks):
        return separate_3stem_batch(params4, params2, tracks, cfg)

    fn = jax.shard_map(
        local, mesh=flat, in_specs=(P(), P(), P("data")), out_specs=P("data")
    )
    return jax.jit(fn), flat.devices.size


def separate_3stem_batch_sharded(
    params4: Params,  # pass-1 (4-stem-family) net, NO leading stem axis
    params2: Params,  # pass-2 (2-stem) net
    tracks: jax.Array,  # (n_tracks, 2, n) pre-padded to equal length
    cfg: SeparatorConfig,
    mesh: Mesh,
) -> jax.Array:
    """Batched 3-stem separation with tracks sharded over the mesh;
    returns (n_tracks, 3 stems, 2ch, out_len). Track counts not divisible
    by the device count are zero-padded and cropped."""
    fn, n_devices = make_batch3_fn(cfg, mesh)
    n_tracks = tracks.shape[0]
    padded = -(-n_tracks // n_devices) * n_devices
    if padded != n_tracks:
        tracks = jnp.pad(tracks, ((0, padded - n_tracks), (0, 0), (0, 0)))
    return fn(params4, params2, tracks)[:n_tracks]


def separate_batch_sharded(
    stacked_params: Params,
    tracks: jax.Array,  # (n_tracks, 2, n) pre-padded to equal length
    cfg: SeparatorConfig,
    mesh: Mesh,
) -> jax.Array:
    """Batched multi-track separation with tracks sharded over the mesh.

    The BASELINE "64 stereo tracks concurrently, sharded across cards"
    config: every track runs the full N-stem graph on its shard's device. Returns (n_tracks, S, 2, out_len). Track counts not divisible
    by the device count are zero-padded and cropped.
    """
    n_stems = jax.tree.leaves(stacked_params)[0].shape[0]
    fn, n_devices = make_batch_fn(cfg, mesh, n_stems)
    n_tracks = tracks.shape[0]
    padded = -(-n_tracks // n_devices) * n_devices
    if padded != n_tracks:
        tracks = jnp.pad(tracks, ((0, padded - n_tracks), (0, 0), (0, 0)))
    return fn(stacked_params, tracks)[:n_tracks]


def compute_masks_sharded_single(
    params: Params,
    spec: jax.Array,
    cfg: SeparatorConfig,
    mesh: Mesh,
    stem_mode: int,
) -> jax.Array:
    """Single-net masks with tiles sharded over EVERY mesh device.

    The reference's primary CLI modes are the single-subnet 2-stem and
    two-pass 3-stem graphs (Executable/main.c:779-970); their frame-block
    data parallelism maps to tiles over the flattened mesh. Runs under
    `shard_map` with replicated params. Returns (2, n_frames, bin_limit),
    replicated.
    """
    from spleeterrt_tpu.core.model import unet_forward

    flat = Mesh(mesh.devices.reshape(-1), ("data",))
    tiles = spec_to_tiles(spec, cfg)
    tiles, n_tiles = _pad_tiles(tiles, flat.devices.size)

    fwd = jax.shard_map(
        lambda p, t: unet_forward(
            p, t, stem_mode, cfg.compute_dtype, cfg.sigmoid
        ),
        mesh=flat,
        in_specs=(P(), P("data")),
        out_specs=P("data"),
    )
    masks = jax.jit(fwd)(params, tiles)[:n_tiles]
    return tiles_to_frames(masks, spec.shape[-2])


def separate_2stem_sharded(
    params: Params,
    audio: jax.Array,  # (2, final_size) pre-padded
    cfg: SeparatorConfig,
    mesh: Mesh,
) -> jax.Array:
    """Mesh-sharded 2-stem graph (Executable/main.c:779-808): vocals =
    istft(mask * spec), accompaniment = input - vocals in time. Tiles shard
    over all devices; the transforms run replicated.
    Returns (2, 2ch, out_len), matching core.separate.separate_2stem."""
    from spleeterrt_tpu.config import STEM_MODE_2
    from spleeterrt_tpu.core.separate import apply_mask

    data_size = audio.shape[-1]

    def fn(params, audio):
        spec = transform.stft(audio, cfg.transform, data_size)
        masks = compute_masks_sharded_single(
            params, spec, cfg, mesh, STEM_MODE_2
        )
        vocal = transform.istft(apply_mask(spec, masks, cfg), cfg.transform)
        pad = vocal.shape[-1] - data_size
        residual = jnp.pad(audio, ((0, 0), (0, pad))) - vocal
        return jnp.stack([vocal, residual])

    return jax.jit(fn)(params, audio)


def separate_3stem_sharded(
    params4: Params,
    params2: Params,
    audio: jax.Array,  # (2, final_size) pre-padded
    cfg: SeparatorConfig,
    mesh: Mesh,
) -> jax.Array:
    """Mesh-sharded two-pass 3-stem graph (Executable/main.c:845-970):
    pass 1 masks drums (4-stem-family net); the FREQUENCY-domain residual
    feeds pass 2 (2-stem net) for vocals; accompaniment = istft(residual) -
    vocals in time. Tiles shard over all devices in both passes.
    Returns (3, 2ch, out_len) = (drums, vocals, accompaniment)."""
    from spleeterrt_tpu.config import STEM_MODE_2
    from spleeterrt_tpu.core.separate import apply_mask

    data_size = audio.shape[-1]

    def fn(params4, params2, audio):
        spec = transform.stft(audio, cfg.transform, data_size)
        drum_masks = compute_masks_sharded_single(
            params4, spec, cfg, mesh, STEM_MODE_4
        )
        drum_spec = apply_mask(spec, drum_masks, cfg)
        residual_spec = spec - drum_spec
        drums = transform.istft(drum_spec, cfg.transform)
        vocal_masks = compute_masks_sharded_single(
            params2, residual_spec, cfg, mesh, STEM_MODE_2
        )
        vocals = transform.istft(
            apply_mask(residual_spec, vocal_masks, cfg), cfg.transform
        )
        accompaniment = transform.istft(residual_spec, cfg.transform) - vocals
        return jnp.stack([drums, vocals, accompaniment])

    return jax.jit(fn)(params4, params2, audio)


def make_stream_fn(cfg: SeparatorConfig, mesh: Mesh, n_stems: int = 4,
                   out_band: tuple[float, ...] | None = None):
    """Cached-compile streaming step with K streams sharded over the mesh.

    The multi-card serving shape for the RT engine: each device runs
    `runtime.stream.block_step_streams` on its local K/N streams; streams
    are independent, so there is zero cross-device communication (one VST
    instance per CPU, VST/Source/Spleeter4Stems.c:512-582, scaled to a
    mesh).
    Returns (step_fn, n_devices): step_fn(params, state, blocks) ->
    (new_state, out_blocks) where every state leaf and blocks carry a
    leading K axis divisible by n_devices.
    """
    from spleeterrt_tpu.runtime import stream as stream_mod

    if out_band is None:
        out_band = stream_mod.RT_OUT_BAND[:n_stems]
    flat = Mesh(mesh.devices.reshape(-1), ("data",))

    def local(params, state, blocks):
        return stream_mod.block_step_streams(
            params, state, blocks, cfg, n_stems, out_band
        )

    fn = jax.shard_map(
        local, mesh=flat,
        in_specs=(P(), P("data"), P("data")),
        out_specs=(P("data"), P("data")),
    )
    return jax.jit(fn), flat.devices.size


def stream_scan_sharded(
    stacked_params: Params,
    audio: jax.Array,  # (2, n_blocks * T * hop)
    cfg: SeparatorConfig,
    mesh: Mesh,
    n_stems: int = 4,
    out_band: tuple[float, ...] | None = None,
    freq_temporal: float = 1.0,
) -> jax.Array:
    """Streaming engine with the per-stem U-Nets sharded over "stem".

    The mesh mapping of the VST's 4 background NN threads
    (VST/Source/Spleeter4Stems.c TASK_NB=5): under `shard_map`, each stem
    group's devices scan the whole signal for THEIR stems -- mask
    inference, masked synthesis, and overlap-add are all per-stem, so there
    is zero cross-device communication; only the analysis rFFT is computed
    redundantly per group. Output matches runtime.stream.stream_scan
    (tests/test_sharding.py). Stem counts that do not divide the "stem"
    axis are partitioned by GSPMD from the params' sharding.
    """
    from spleeterrt_tpu.runtime import stream as stream_mod

    if out_band is None:
        out_band = stream_mod.RT_OUT_BAND[:n_stems]
    n_stem_ax = mesh.shape["stem"]

    if n_stems % n_stem_ax == 0:
        s_local = n_stems // n_stem_ax
        uw = jnp.asarray(out_band, jnp.float32)

        def local(params, uw_l, audio):
            return stream_mod._stream_scan_impl(
                params, audio, cfg, s_local, uw_l, freq_temporal
            )

        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("stem"), P("stem"), P()),
            out_specs=P("stem"),
            # The scan's initial carry (stream.init_state) is replicated and
            # its body output is stem-varying; skip the carry vma check.
            check_vma=False,
        )
        return jax.jit(fn)(stacked_params, uw, audio)

    params = shard_params(stacked_params, mesh, stem_sharded=True)

    def fn(params, audio):
        return stream_mod.stream_scan(
            params, audio, cfg, n_stems, out_band, freq_temporal=freq_temporal
        )

    return jax.jit(fn)(params, audio)
