"""Training data pipeline: dataset loading, cropping, magnitude batching."""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from spleeterrt_tpu.config import SeparatorConfig
from spleeterrt_tpu.core import model, train, weights
from spleeterrt_tpu.data import dataset as ds
from spleeterrt_tpu.io import audio

CFG = SeparatorConfig(
    bin_limit=512, time_step=64, num_stems=2, compute_dtype=jnp.float32
)
STEMS = ("vocals", "accompaniment")


def _make_dataset(tmp_path, rng, n_tracks=2, n=70000):
    for k in range(n_tracks):
        d = tmp_path / f"track{k}"
        d.mkdir()
        t = np.arange(n) / 44100.0
        vocals = (0.3 * np.sin(2 * np.pi * (300 + 100 * k) * t))[None].repeat(2, 0)
        acc = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
        audio.write_wav(d / "vocals.wav", vocals.astype(np.float32), 44100)
        audio.write_wav(d / "accompaniment.wav", acc, 44100)
        audio.write_wav(d / "mixture.wav", (vocals + acc).astype(np.float32), 44100)
    return ds.StemDataset(tmp_path, STEMS)


def test_dataset_crops_and_batches(tmp_path, rng):
    data = _make_dataset(tmp_path, rng)
    assert len(data.tracks) == 2
    assert all(t.streaming for t in data.tracks)  # header-only WAV handles
    crop = ds.crop_samples(CFG)
    mix, stems = data.sample_crop(rng, crop)
    assert mix.shape == (2, crop)
    assert stems.shape == (2, 2, crop)
    # mixture == sum of stems for these synthetic tracks
    np.testing.assert_allclose(mix, stems.sum(0), atol=2e-4)

    it = ds.batches(data, CFG, batch_size=3, steps=2)
    mix_mag, tgt, active = next(it)
    assert mix_mag.shape == (3, 64, 512, 2)
    assert tgt.shape == (2, 3, 64, 512, 2)
    assert active.shape == (2, 3)
    assert np.all(np.asarray(active) == 1.0)  # both stems audible
    assert np.all(np.isfinite(np.asarray(mix_mag)))


def test_streaming_crop_matches_full_decode(tmp_path, rng):
    """Seeked partial reads == slices of the fully-decoded track."""
    data = _make_dataset(tmp_path, rng, n_tracks=1)
    tr = data.tracks[0]
    full = audio.read_wav(tmp_path / "track0" / "mixture.wav").samples
    mix, stems = tr.read_crop(12345, 4096)
    np.testing.assert_array_equal(mix, full[:, 12345 : 12345 + 4096])
    # Past-the-end crops zero-pad.
    n = tr.n_frames
    mix2, _ = tr.read_crop(n - 100, 256)
    np.testing.assert_array_equal(mix2[:, :100], full[:, n - 100 :])
    assert np.all(mix2[:, 100:] == 0)


def test_train_on_dataset_reduces_loss(tmp_path, rng):
    data = _make_dataset(tmp_path, rng)
    stacked = weights.stack_params(
        [model.init_params(jax.random.PRNGKey(i)) for i in range(2)]
    )
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    state = train.init_train_state(stacked, opt, ema=True)
    step = jax.jit(train.make_train_step(opt, compute_dtype=jnp.float32))

    losses = []
    for mix_mag, tgt, active in ds.batches(data, CFG, batch_size=2, steps=8, seed=1):
        state, loss = step(state, mix_mag, tgt, active)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    # EMA tracked: moved off init, not equal to raw params.
    d10 = np.asarray(state.ema_params["down1"]["w"][0])
    assert not np.array_equal(d10, np.asarray(stacked["down1"]["w"][0]))
    assert not np.array_equal(d10, np.asarray(state.params["down1"]["w"][0]))


def test_silent_stem_masking_zeroes_gradient(tmp_path, rng):
    """A stem marked silent contributes nothing: its net's gradient is zero
    and the loss equals the active-stems-only loss."""
    stacked = weights.stack_params(
        [model.init_params(jax.random.PRNGKey(i)) for i in range(2)]
    )
    mix = jnp.asarray(
        np.abs(rng.standard_normal((2, 64, 512, 2))).astype(np.float32)
    )
    tgt = jnp.asarray(
        np.abs(rng.standard_normal((2, 2, 64, 512, 2))).astype(np.float32)
    )
    tgt = tgt.at[1].set(0.0)  # stem 1's crops are silence
    active = jnp.asarray([[1.0, 1.0], [0.0, 0.0]])

    loss, grads = jax.value_and_grad(train.separation_loss)(
        stacked, mix, tgt, compute_dtype=jnp.float32, active=active
    )
    g1 = np.concatenate(
        [np.asarray(l[1]).ravel() for l in jax.tree.leaves(grads)]
    )
    assert np.all(g1 == 0.0)
    g0 = np.concatenate(
        [np.asarray(l[0]).ravel() for l in jax.tree.leaves(grads)]
    )
    assert np.any(g0 != 0.0)
    # Weighted loss == plain mean over the active (stem, batch) cells only.
    masks = jax.jit(
        lambda p: __import__(
            "spleeterrt_tpu.core.model", fromlist=["multi_stem_forward"]
        ).multi_stem_forward(p, mix, 1, jnp.float32, "exact")
    )(stacked)
    est = np.asarray(masks) * np.asarray(mix)[None]
    expect = np.mean(np.abs(est[0] - np.asarray(tgt)[0]))
    np.testing.assert_allclose(float(loss), expect, rtol=1e-6)


def test_separation_loss_grad_matches_finite_difference(rng):
    """The loss's reverse-mode gradient agrees with a central difference
    along a random direction in every weight (the training graph is the
    same plain formulation the inference paths run)."""
    stacked = weights.stack_params(
        [model.init_params(jax.random.PRNGKey(i)) for i in range(2)]
    )
    mix = jnp.asarray(
        np.abs(rng.standard_normal((1, 64, 512, 2))).astype(np.float32)
    )
    tgt = jnp.asarray(
        np.abs(rng.standard_normal((2, 1, 64, 512, 2))).astype(np.float32)
    )
    loss = lambda p: train.separation_loss(p, mix, tgt, compute_dtype=jnp.float32)
    leaves, tree = jax.tree.flatten(stacked)
    d = jax.tree.unflatten(
        tree,
        [jnp.asarray(rng.standard_normal(l.shape), jnp.float32) for l in leaves],
    )
    grads = jax.grad(loss)(stacked)
    directional = sum(
        float(jnp.vdot(g, v)) for g, v in zip(jax.tree.leaves(grads), jax.tree.leaves(d))
    )
    eps = 1e-3
    step = lambda s: jax.tree.map(lambda p, v: p + s * eps * v, stacked, d)
    fd = (float(loss(step(1.0))) - float(loss(step(-1.0)))) / (2 * eps)
    assert np.isfinite(directional)
    np.testing.assert_allclose(directional, fd, rtol=2e-2)


def test_deploy_params_folds_training_scale(rng):
    """net(mag/fft) == deploy_params(net)(mag): trained nets drop into the
    raw-magnitude inference graph."""
    from spleeterrt_tpu.core.model import multi_stem_forward

    stacked = weights.stack_params([model.init_params(jax.random.PRNGKey(7))])
    mag = jnp.asarray(
        np.abs(rng.standard_normal((1, 64, 512, 2))).astype(np.float32) * 100
    )
    a = multi_stem_forward(stacked, mag / 4096.0, 1, jnp.float32, "exact")
    folded = train.deploy_params(stacked, 4096)
    b = multi_stem_forward(
        jax.tree.map(jnp.asarray, folded), mag, 1, jnp.float32, "exact"
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_evaluate_si_sdr_runs(tmp_path, rng):
    data = _make_dataset(tmp_path, rng, n_tracks=2, n=70000)
    stacked = weights.stack_params(
        [model.init_params(jax.random.PRNGKey(i)) for i in range(2)]
    )
    rep = train.evaluate_si_sdr(stacked, data, CFG, seconds=1.0)
    assert set(rep) == {"vocals", "accompaniment", "mean"}
    assert all(np.isfinite(v) for v in rep.values())


def test_missing_mixture_synthesized(tmp_path, rng):
    d = tmp_path / "t0"
    d.mkdir()
    x1 = (0.2 * rng.standard_normal((2, 30000))).astype(np.float32)
    x2 = (0.2 * rng.standard_normal((2, 30000))).astype(np.float32)
    audio.write_wav(d / "vocals.wav", x1, 44100)
    audio.write_wav(d / "accompaniment.wav", x2, 44100)
    data = ds.StemDataset(tmp_path, STEMS)
    np.testing.assert_allclose(
        data.tracks[0].mixture, x1 + x2, atol=1e-6
    )
