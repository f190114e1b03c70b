"""Layer-geometry and full-forward parity vs the index-arithmetic oracle."""

import numpy as np
import jax
import jax.numpy as jnp

from spleeterrt_tpu.config import STEM_MODE_2, STEM_MODE_4
from spleeterrt_tpu.core import model, weights
from tests.oracle import reference_oracle as oracle


def _np32(a):
    return np.asarray(a, dtype=np.float32)


def test_conv5x5_s2_geometry(rng):
    """TF-SAME (1,2) padding matches the reference im2col index arithmetic."""
    for h, w in ((8, 8), (16, 12), (64, 64)):
        x = rng.standard_normal((3, h, w))
        k = rng.standard_normal((5, 3, 5, 5)) * 0.1
        b = rng.standard_normal(5)
        ref = oracle.conv5x5_s2(x, k, b)

        x_nhwc = jnp.asarray(x.transpose(1, 2, 0)[None], jnp.float32)
        k_hwio = jnp.asarray(k.transpose(2, 3, 1, 0), jnp.float32)
        got = model._conv_same(x_nhwc, k_hwio) + jnp.asarray(b, jnp.float32)
        got = np.asarray(got)[0].transpose(2, 0, 1)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_tconv5x5_s2_geometry(rng):
    """lhs-dilated conv with flipped kernel == reference col2im scatter."""
    for h, w in ((4, 4), (8, 6), (32, 32)):
        x = rng.standard_normal((4, h, w))
        k = rng.standard_normal((4, 3, 5, 5)) * 0.1  # (Cin, Cout, kh, kw)
        ref = oracle.tconv5x5_s2(x, k)

        x_nhwc = jnp.asarray(x.transpose(1, 2, 0)[None], jnp.float32)
        k_hwio = jnp.asarray(k.transpose(2, 3, 0, 1), jnp.float32)
        got = np.asarray(model._tconv_same(x_nhwc, k_hwio))[0].transpose(2, 0, 1)
        assert got.shape == (3, 2 * h, 2 * w)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_final_dilated_conv_geometry(rng):
    for h, w in ((8, 8), (10, 14), (64, 64)):
        x = rng.standard_normal((1, h, w))
        k = rng.standard_normal((2, 1, 4, 4)) * 0.1
        b = rng.standard_normal(2)
        ref = oracle.conv4x4_d2(x, k, b)

        x_nhwc = jnp.asarray(x.transpose(1, 2, 0)[None], jnp.float32)
        k_hwio = jnp.asarray(k.transpose(2, 3, 1, 0), jnp.float32)
        got = model._conv_dilated_final(x_nhwc, k_hwio) + jnp.asarray(b, jnp.float32)
        got = np.asarray(got)[0].transpose(2, 0, 1)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_blob_round_trip(rng):
    blob = weights.random_blob(rng)
    params = weights.blob_to_params(blob)
    assert weights.params_to_blob(params) == blob
    # shape sanity
    assert params["down1"]["w"].shape == (5, 5, 2, 16)
    assert params["up1"]["w"].shape == (5, 5, 512, 256)
    assert params["up7"]["w"].shape == (4, 4, 1, 2)
    assert "bn_scale" not in params["down6"]


def test_fp16_daz_decode():
    cases = np.array(
        [
            0x0000,  # +0
            0x8000,  # -0
            0x0001,  # +denormal -> +0
            0x8001,  # -denormal -> -0
            0x3C00,  # 1.0
            0xBC00,  # -1.0
            0x3555,  # ~0.3333
            0x7BFF,  # 65504 (max)
        ],
        dtype=np.uint16,
    )
    got = weights.decode_fp16_daz(cases)
    expect = np.array([0.0, -0.0, 0.0, -0.0, 1.0, -1.0, 0.33325195, 65504.0],
                      dtype=np.float32)
    np.testing.assert_array_equal(got, expect)
    assert np.signbit(got[1]) and np.signbit(got[3])

    # Round-trip normal fp16 values exactly.
    vals = np.float32([0.5, -2.25, 1e-3, 100.0])
    np.testing.assert_array_equal(
        weights.decode_fp16_daz(weights.encode_fp16(vals)),
        vals.astype(np.float16).astype(np.float32),
    )


def test_quantized_model_decode(rng):
    flat = (rng.standard_normal(2 * weights.COEFF_BLOB_FLOATS) * 0.05).astype(
        np.float32
    )
    halves = weights.encode_fp16(flat)
    p4, p2 = weights.load_quantized_model(halves.tobytes())
    ref4 = weights.blob_to_params(
        weights.decode_fp16_daz(halves[: weights.COEFF_BLOB_FLOATS])
    )
    np.testing.assert_array_equal(
        _np32(p4["down3"]["w"]), _np32(ref4["down3"]["w"])
    )
    assert p2["up7"]["b"].shape == (2,)


def test_unet_forward_matches_oracle(rng):
    """Full 13-layer forward vs the oracle on the smallest legal tile."""
    blob = weights.random_blob(rng, scale=0.02)
    fields = oracle.unpack_blob(blob)
    params = weights.blob_to_params(blob)

    t, f = 64, 512
    mag = np.abs(rng.standard_normal((2, t, f))) * 2.0

    for mode in (STEM_MODE_2, STEM_MODE_4):
        ref = oracle.unet(fields, mag, stem_mode=mode)
        got = model.unet_forward(
            params,
            jnp.asarray(mag.transpose(1, 2, 0)[None], jnp.float32),
            stem_mode=mode,
            compute_dtype=jnp.float32,
        )
        got = np.asarray(got)[0].transpose(2, 0, 1)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_multi_stem_forward(rng):
    blobs = [weights.random_blob(rng, scale=0.02) for _ in range(4)]
    stacked = weights.stack_params([weights.blob_to_params(b) for b in blobs])
    mag = jnp.asarray(
        np.abs(rng.standard_normal((1, 64, 512, 2))), jnp.float32
    )
    out = model.multi_stem_forward(stacked, mag, compute_dtype=jnp.float32)
    assert out.shape == (4, 1, 64, 512, 2)
    # Each stem must equal its individual forward.
    one = model.unet_forward(
        weights.blob_to_params(blobs[2]), mag, compute_dtype=jnp.float32
    )
    np.testing.assert_allclose(
        np.asarray(out[2]), np.asarray(one), atol=1e-5, rtol=1e-5
    )


def test_fast_sigmoid():
    x = jnp.asarray(np.linspace(-9, 9, 1001), jnp.float32)
    got = np.asarray(model.fast_sigmoid(x))
    ref = 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))
    # Piecewise-linear over 1025 knots: max interp error ~ 2.4e-5; clamps
    # outside [-7, 7] introduce up to sigmoid(-7) ~ 9e-4.
    assert np.all(np.abs(got - ref) < 1e-3)
    assert got[0] == 0.0 and got[-1] == 1.0


def test_init_params_structure():
    params = model.init_params(jax.random.PRNGKey(0))
    assert set(params) == {f"down{i}" for i in range(1, 7)} | {
        f"up{i}" for i in range(1, 8)
    }
    mag = jnp.ones((1, 64, 512, 2), jnp.float32)
    mask = model.unet_forward(params, mag, compute_dtype=jnp.float32)
    assert mask.shape == (1, 64, 512, 2)
    m = np.asarray(mask)
    assert np.all((m >= 0) & (m <= 1))


def test_fast_layouts_exact(rng):
    """The subpixel/space-to-depth rewrites the forward uses equal the
    canonical (oracle-checked) convs, at a generic shape and at the real
    widths of enc1 (2->16), up5 (64->16) and up6 (32->1)."""
    x = jnp.asarray(rng.standard_normal((2, 16, 12, 8)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((5, 5, 8, 3)) * 0.1, jnp.float32)
    np.testing.assert_allclose(
        np.asarray(model._tconv_subpixel(x, w)),
        np.asarray(model._tconv_same(x, w)),
        atol=1e-5,
    )
    w2 = jnp.asarray(rng.standard_normal((5, 5, 8, 16)) * 0.1, jnp.float32)
    np.testing.assert_allclose(
        np.asarray(model._conv_same_s2d(x, w2)),
        np.asarray(model._conv_same(x, w2)),
        atol=1e-5,
    )
    for cin, cout, fn, ref in (
        (2, 16, model._conv_same_s2d, model._conv_same),
        (64, 16, model._tconv_subpixel, model._tconv_same),
        (32, 1, model._tconv_subpixel, model._tconv_same),
    ):
        x = jnp.asarray(rng.standard_normal((1, 8, 16, cin)), jnp.float32)
        w = jnp.asarray(rng.standard_normal((5, 5, cin, cout)) * 0.1, jnp.float32)
        np.testing.assert_allclose(
            np.asarray(fn(x, w)), np.asarray(ref(x, w)), atol=1e-5
        )


def test_grouped_multi_stem_matches_vmap(rng):
    """Stem-grouped forward == vmapped per-stem forwards (exact math)."""
    from spleeterrt_tpu.core import grouped

    blobs = [weights.random_blob(rng, scale=0.02) for _ in range(4)]
    stacked = weights.stack_params([weights.blob_to_params(b) for b in blobs])
    mag = jnp.asarray(
        np.abs(rng.standard_normal((2, 64, 512, 2))), jnp.float32
    )
    ref = model.multi_stem_forward(stacked, mag, 1, jnp.float32)
    got = grouped.multi_stem_forward_grouped(stacked, mag, 1, jnp.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-5)
