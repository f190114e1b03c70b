"""Training for the Spleeter U-Net (a capability the reference lacks).

The reference ships fixed pre-trained weights only (Executable/model.7z,
VST .dat blobs; no training code anywhere). To make the framework
self-sufficient we provide the standard Spleeter training objective: per-stem
L1 between `mask * |mix|` and the target stem magnitude, optimized with
optax, with the stem axis sharded like inference (parallel/mesh.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spleeterrt_tpu.config import STEM_MODE_4
from spleeterrt_tpu.core.model import Params, multi_stem_forward


class TrainState(NamedTuple):
    params: Params  # stacked per-stem params (leading stem axis)
    opt_state: optax.OptState
    step: jax.Array
    ema_params: Params | None = None  # EMA shadow (deployment weights)


def separation_loss(
    stacked_params: Params,
    mix_mag: jax.Array,
    target_mags: jax.Array,
    stem_mode: int = STEM_MODE_4,
    compute_dtype=jnp.bfloat16,
    active: jax.Array | None = None,
) -> jax.Array:
    """L1(mask * |mix|, |stem|) averaged over stems.

    mix_mag: (B, T, F, 2); target_mags: (S, B, T, F, 2); active: optional
    (S, B) 0/1 weights -- silent-stem crops (all-zero targets, see
    data/dataset.py::stem_activity) contribute nothing, so a corpus with
    sparse stems doesn't teach the masks to collapse to zero.
    """
    masks = multi_stem_forward(
        stacked_params, mix_mag, stem_mode, compute_dtype, "exact"
    )
    est = masks * mix_mag[None].astype(masks.dtype)
    err = jnp.abs(est - target_mags.astype(masks.dtype))
    if active is None:
        return jnp.mean(err)
    per = jnp.mean(err, axis=tuple(range(2, err.ndim)))  # (S, B)
    w = active.astype(per.dtype)
    return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)


def init_train_state(
    stacked_params: Params,
    optimizer: optax.GradientTransformation,
    ema: bool = False,
) -> TrainState:
    return TrainState(
        params=stacked_params,
        opt_state=optimizer.init(stacked_params),
        step=jnp.zeros((), jnp.int32),
        ema_params=jax.tree.map(jnp.copy, stacked_params) if ema else None,
    )


def make_train_step(
    optimizer: optax.GradientTransformation,
    stem_mode: int = STEM_MODE_4,
    compute_dtype=jnp.bfloat16,
    ema_decay: float = 0.999,
):
    """Returns `train_step(state, mix_mag, target_mags, active=None)
    -> (state, loss)`. If the state carries `ema_params`, they track the
    optimized params with bias-corrected decay `ema_decay`."""

    def train_step(state: TrainState, mix_mag, target_mags, active=None):
        loss, grads = jax.value_and_grad(separation_loss)(
            state.params, mix_mag, target_mags, stem_mode, compute_dtype,
            active,
        )
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        step = state.step + 1
        ema = state.ema_params
        if ema is not None:
            # Bias-corrected EMA (Adam-style): early steps track params.
            d = ema_decay * (1.0 - 1.0 / (step.astype(jnp.float32) + 1.0))
            ema = jax.tree.map(lambda e, p: d * e + (1.0 - d) * p, ema, params)
        return TrainState(params, opt_state, step, ema), loss

    return train_step


def deploy_params(stacked_params: Params, fft_size: int = 4096) -> Params:
    """Fold the training input scale into the first conv.

    Training feeds |rfft|/fft_size (data/dataset.py::to_magnitudes) for O(1)
    activations; the inference graph (core/separate.py::compute_masks) feeds
    raw |rfft|. conv1 is linear in its input, so scaling its weights by
    1/fft_size makes the trained nets drop into the inference graph and the
    reference's blob format unchanged (the reference's pre-trained weights
    absorb raw magnitudes the same way, Executable/spleeter.c:177).
    """
    out = {k: dict(v) for k, v in stacked_params.items()}
    out["down1"] = dict(out["down1"])
    out["down1"]["w"] = stacked_params["down1"]["w"] / float(fft_size)
    return out


def evaluate_si_sdr(
    stacked_params: Params,
    dataset,
    cfg,
    seconds: float = 12.0,
    out_band: tuple[float, ...] | None = None,
    trained_scale: bool = True,
) -> dict[str, float]:
    """Holdout evaluation: run the REAL separation pipeline (STFT -> masks
    -> iSTFT, core/separate.py) on a centered segment of every track in
    `dataset` and report mean per-stem time-domain SI-SDR in dB (plus
    'mean'). `trained_scale` folds the training input scale first
    (see :func:`deploy_params`)."""
    import numpy as np

    from spleeterrt_tpu.core import separate as sep
    from spleeterrt_tpu.core import transform
    from spleeterrt_tpu.utils import metrics

    names = tuple(dataset.stem_names)
    params = (
        deploy_params(stacked_params, cfg.transform.fft_size)
        if trained_scale
        else stacked_params
    )
    ob = tuple(out_band) if out_band is not None else (0.0,) * len(names)
    sums = {s: 0.0 for s in names}
    sr = getattr(dataset, "sample_rate", 44100)
    for tr in dataset.tracks:
        n = min(int(seconds * sr), tr.n_frames)
        start = (tr.n_frames - n) // 2
        mix, stems = tr.read_crop(start, n)
        preshift, _ = transform.offline_pad_sizes(n, cfg.transform)
        padded = transform.pad_offline(jnp.asarray(mix), cfg.transform)
        est = np.asarray(
            sep.separate_nstem(params, padded, cfg, ob)
        )[..., preshift : preshift + n]
        for i, s in enumerate(names):
            sums[s] += metrics.si_sdr_db(est[i], stems[i])
    report = {s: v / len(dataset.tracks) for s, v in sums.items()}
    report["mean"] = sum(report.values()) / len(names)
    return report


def shard_train_state(state: TrainState, mesh: Mesh, n_stems: int) -> TrainState:
    """Place the train state on the mesh: every leaf whose leading axis is
    the stem axis shards over "stem" (expert-style model parallelism of the
    per-stem nets); scalars (optimizer counts, step) replicate."""

    def place(leaf):
        leaf = jnp.asarray(leaf)
        stem_led = leaf.ndim >= 1 and leaf.shape[0] == n_stems
        spec = P("stem") if stem_led else P()
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(place, state)


def make_sharded_train_step(
    mesh: Mesh,
    optimizer: optax.GradientTransformation,
    stem_mode: int = STEM_MODE_4,
    compute_dtype=jnp.bfloat16,
    ema_decay: float = 0.999,
):
    """jit the train step over a (stem, data) mesh.

    State must be placed with :func:`shard_train_state`; batch inputs shard
    their batch axis over "data" (data parallelism over spectrogram tiles)
    and targets additionally shard stems over "stem". Stem-sharded params
    need no cross-stem collective; the batch-mean gradient reduction becomes
    a psum over "data" via sharding propagation.
    """
    step = make_train_step(optimizer, stem_mode, compute_dtype, ema_decay)

    def sharded_step(state, mix_mag, target_mags, active=None):
        mix_mag = jax.lax.with_sharding_constraint(
            mix_mag, NamedSharding(mesh, P("data"))
        )
        target_mags = jax.lax.with_sharding_constraint(
            target_mags, NamedSharding(mesh, P("stem", "data"))
        )
        if active is not None:
            active = jax.lax.with_sharding_constraint(
                active, NamedSharding(mesh, P("stem", "data"))
            )
        return step(state, mix_mag, target_mags, active)

    return jax.jit(sharded_step, donate_argnums=(0,))
