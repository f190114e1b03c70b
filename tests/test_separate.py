"""End-to-end offline separation parity vs the oracle + stem-graph laws."""

import numpy as np
import pytest
import jax.numpy as jnp

from spleeterrt_tpu.config import SeparatorConfig, TransformConfig
from spleeterrt_tpu.core import separate, transform, weights
from tests.oracle import reference_oracle as oracle

CFG2 = SeparatorConfig(
    bin_limit=512, time_step=64, num_stems=2, compute_dtype=jnp.float32
)


def _audio(rng, n=30000):
    t = np.arange(n) / 44100.0
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)
    return np.stack([x, 0.8 * x]).astype(np.float32)


def test_2stem_matches_oracle(rng):
    blob = weights.random_blob(rng, scale=0.02)
    params = weights.blob_to_params(blob)
    fields = oracle.unpack_blob(blob)
    audio = _audio(rng)
    n = audio.shape[-1]

    got = separate.separate(audio, params=params, cfg=CFG2)
    ref_vocal, ref_acc = oracle.offline_separate_2stem(
        fields, audio.astype(np.float64), n, CFG2.bin_limit, CFG2.time_step
    )

    np.testing.assert_allclose(
        np.asarray(got["vocals"]), ref_vocal, atol=5e-4, rtol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(got["accompaniment"]), ref_acc, atol=5e-4, rtol=1e-3
    )
    # Conservation: vocals + accompaniment == input (time-domain residual).
    np.testing.assert_allclose(
        np.asarray(got["vocals"]) + np.asarray(got["accompaniment"]),
        audio,
        atol=1e-5,
    )


def test_3stem_graph(rng):
    cfg = SeparatorConfig(
        bin_limit=512, time_step=64, num_stems=3, compute_dtype=jnp.float32
    )
    p4 = weights.blob_to_params(weights.random_blob(rng, scale=0.02))
    p2 = weights.blob_to_params(weights.random_blob(rng, scale=0.02))
    audio = _audio(rng, 20000)
    got = separate.separate(audio, params4=p4, params2=p2, cfg=cfg)
    assert set(got) == {"drums", "vocals", "accompaniment"}
    for stem in got.values():
        assert stem.shape == audio.shape

    # drums + (vocals + accompaniment) reconstructs the input up to the
    # unaffected-band attenuation: residual spectrum = orig - masked, and
    # vocals + accompaniment = istft(residual) exactly (main.c:922-928).
    # So drums + vocals + accompaniment = istft(orig spectra) = input.
    total = sum(np.asarray(s) for s in got.values())
    np.testing.assert_allclose(total, audio, atol=1e-4)


def test_4stem_graph(rng):
    cfg = SeparatorConfig(
        bin_limit=512, time_step=64, num_stems=4, compute_dtype=jnp.float32
    )
    stacked = weights.stack_params(
        [weights.blob_to_params(weights.random_blob(rng, 0.02)) for _ in range(4)]
    )
    audio = _audio(rng, 16000)
    got = separate.separate(audio, stacked_params=stacked, cfg=cfg)
    assert set(got) == {"drums", "bass", "accompaniment", "vocals"}
    for stem in got.values():
        assert stem.shape == audio.shape
        assert np.all(np.isfinite(np.asarray(stem)))


def test_mono_input_upmix(rng):
    params = weights.blob_to_params(weights.random_blob(rng, 0.02))
    mono = _audio(rng, 12000)[0]
    got = separate.separate(mono, params=params, cfg=CFG2)
    assert got["vocals"].shape == (2, 12000)


def test_tile_padding_roundtrip(rng):
    cfg = CFG2
    n_frames = 150  # not a multiple of time_step=64 -> padded tail tile
    spec = jnp.asarray(
        rng.standard_normal((2, n_frames, 2049))
        + 1j * rng.standard_normal((2, n_frames, 2049)),
        jnp.complex64,
    )
    tiles = separate.spec_to_tiles(spec, cfg)
    assert tiles.shape == (3, 64, 512, 2)
    back = separate.tiles_to_frames(tiles, n_frames)
    np.testing.assert_allclose(
        np.asarray(back), np.abs(np.asarray(spec))[:, :, :512], atol=1e-5
    )


def test_bf16_pipeline_snr_vs_fp32(rng):
    """The production bf16 compute path stays within a tight SNR bound of the
    fp32 (oracle-verified) path -- the BASELINE.md acceptance style check."""
    from spleeterrt_tpu.utils import metrics

    blob = weights.random_blob(rng, scale=0.02)
    params = weights.blob_to_params(blob)
    audio = _audio(rng, 40000)

    ref = separate.separate(audio, params=params, cfg=CFG2)
    cfg_bf16 = SeparatorConfig(
        bin_limit=512, time_step=64, num_stems=2, compute_dtype=jnp.bfloat16
    )
    got = separate.separate(audio, params=params, cfg=cfg_bf16)

    rep = metrics.stem_report(
        {k: np.asarray(v) for k, v in got.items()},
        {k: np.asarray(v) for k, v in ref.items()},
    )
    for stem, m in rep.items():
        assert m["snr_db"] > 30.0, (stem, m)


def _realistic_params(rng, key):
    """Worst-case trained-magnitude params (docs/NUMERICS.md section 6).

    The reference ships trained blobs we cannot load here (model.7z absent),
    so this constructs the adversarial end of plausible trained dynamics:
    he-normal conv weights, folded-BN scales log-uniform over [0.05, 30] with
    random sign (gamma/sqrt(var) can reach O(10) when var is small), shifts
    up to +-8, and a final conv scaled so the sigmoid logits saturate (+-20).
    """
    import jax
    from spleeterrt_tpu.core import model

    p = model.init_params(key)
    out = {}
    for ln, layer in p.items():
        new = dict(layer)
        if "bn_scale" in layer:
            c = layer["bn_scale"].shape[0]
            sgn = rng.choice([-1.0, 1.0], c)
            new["bn_scale"] = jnp.asarray(
                sgn * np.exp(rng.uniform(np.log(0.05), np.log(30.0), c)),
                jnp.float32,
            )
            new["bn_shift"] = jnp.asarray(rng.uniform(-8, 8, c), jnp.float32)
        new["b"] = jnp.asarray(
            rng.uniform(-0.5, 0.5, layer["b"].shape[0]), jnp.float32
        )
        out[ln] = new
    out["up7"] = dict(out["up7"], w=out["up7"]["w"] * 25.0)
    return out


def test_bf16_snr_at_realistic_weight_scale(rng):
    """Pin the production bf16 default at adversarially-scaled weights.

    The toy-scale test above (random 0.02-scale blobs) is a >30 dB check;
    this one drives BN scales to O(30) and saturates the final logits --
    measured 21-35 dB bf16-vs-fp32 across stems/seeds. Bound set at >19 dB
    with seed margin; rationale in docs/NUMERICS.md section 6.
    """
    import jax
    from spleeterrt_tpu.utils import metrics

    params = _realistic_params(rng, jax.random.PRNGKey(7))
    n = 60000
    t = np.arange(n) / 44100.0
    x = (
        0.4 * np.sin(2 * np.pi * 440 * t)
        + 0.2 * np.sin(2 * np.pi * 1870 * t + 0.4)
        + 0.05 * rng.standard_normal(n)
    )
    audio = np.stack([x, 0.8 * x]).astype(np.float32)

    ref = separate.separate(audio, params=params, cfg=CFG2)
    cfg_bf16 = SeparatorConfig(
        bin_limit=512, time_step=64, num_stems=2, compute_dtype=jnp.bfloat16
    )
    got = separate.separate(audio, params=params, cfg=cfg_bf16)
    rep = metrics.stem_report(
        {k: np.asarray(v) for k, v in got.items()},
        {k: np.asarray(v) for k, v in ref.items()},
    )
    for stem, m in rep.items():
        assert m["snr_db"] > 19.0, (stem, m)


def test_5stem_graph(rng):
    cfg = SeparatorConfig(
        bin_limit=512, time_step=64, num_stems=5, compute_dtype=jnp.float32
    )
    stacked = weights.stack_params(
        [weights.blob_to_params(weights.random_blob(rng, 0.02)) for _ in range(5)]
    )
    audio = _audio(rng, 14000)
    got = separate.separate(audio, stacked_params=stacked, cfg=cfg)
    assert set(got) == {"vocals", "drums", "bass", "piano", "other"}
    for stem in got.values():
        assert stem.shape == audio.shape
        assert np.all(np.isfinite(np.asarray(stem)))


def test_wider_config_shapes(rng):
    """bin_limit=1024, time_step=128 (default-CLI-shaped config) end-to-end."""
    cfg = SeparatorConfig(
        bin_limit=1024, time_step=128, num_stems=2, compute_dtype=jnp.float32
    )
    params = weights.blob_to_params(weights.random_blob(rng, 0.02))
    audio = _audio(rng, 150000)
    got = separate.separate(audio, params=params, cfg=cfg)
    np.testing.assert_allclose(
        np.asarray(got["vocals"]) + np.asarray(got["accompaniment"]),
        audio, atol=1e-5,
    )


def _stacked(rng, n):
    return weights.stack_params(
        [weights.blob_to_params(weights.random_blob(rng, 0.02)) for _ in range(n)]
    )


def _batch_case(rng, num_stems, cfg, padded):
    """(batched graph output, per-track graph output) for one stem family."""
    if num_stems == 2:
        p = weights.blob_to_params(weights.random_blob(rng, 0.02))
        got = separate.separate_2stem_batch(p, padded, cfg)
        ref = [separate.separate_2stem(p, a, cfg) for a in padded]
    elif num_stems == 3:
        p4 = weights.blob_to_params(weights.random_blob(rng, 0.02))
        p2 = weights.blob_to_params(weights.random_blob(rng, 0.02))
        got = separate.separate_3stem_batch(p4, p2, padded, cfg)
        ref = [separate.separate_3stem(p4, p2, a, cfg) for a in padded]
    else:
        out_band = separate.OUT_BAND_4 if num_stems == 4 else separate.OUT_BAND_5
        stacked = _stacked(rng, num_stems)
        got = separate.separate_nstem_batch(stacked, padded, cfg, out_band)
        ref = [separate.separate_nstem(stacked, a, cfg, out_band) for a in padded]
    return np.asarray(got), np.stack([np.asarray(r) for r in ref])


@pytest.mark.parametrize("num_stems", [2, 3, 4, 5])
def test_batch_graph_equals_per_track(rng, num_stems):
    """Every batched stem graph is its single-track graph per track."""
    cfg = SeparatorConfig(
        bin_limit=512, time_step=64, num_stems=num_stems,
        compute_dtype=jnp.float32,
    )
    tracks = np.stack([_audio(rng, 9000), _audio(rng, 9000)[::-1]])
    padded = transform.pad_offline(jnp.asarray(tracks), cfg.transform)
    got, ref = _batch_case(rng, num_stems, cfg, padded)
    assert got.shape == ref.shape
    assert got.shape[:2] == (2, num_stems)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize(
    "bin_limit,time_step", [(512, 64), (1024, 64), (1536, 256), (2048, 512)]
)
def test_mask_of_ones_round_trip(rng, bin_limit, time_step):
    """A net whose masks are exactly 1 and an out-of-band weight of 1 make
    the whole N-stem graph (tiles, U-Net, mask multiply, iSTFT at FFT 4096 /
    hop 1024) the identity on the input (unity-gain scale chain,
    Executable/stftFix.c)."""
    import jax
    from spleeterrt_tpu.core import model

    cfg = SeparatorConfig(
        bin_limit=bin_limit, time_step=time_step, num_stems=4,
        compute_dtype=jnp.float32,
    )
    p = model.init_params(jax.random.PRNGKey(0))
    # sigmoid(0 * x + 40) == 1.0 exactly in fp32.
    p["up7"] = {"w": jnp.zeros_like(p["up7"]["w"]), "b": jnp.full((2,), 40.0)}
    audio = _audio(rng, 30000)
    n = audio.shape[-1]
    padded = transform.pad_offline(jnp.asarray(audio), cfg.transform)
    out = separate.separate_nstem(
        weights.stack_params([p]), padded, cfg, (1.0,)
    )
    pre = cfg.transform.fft_size
    np.testing.assert_allclose(
        np.asarray(out)[0, :, pre : pre + n], audio, atol=5e-6
    )
