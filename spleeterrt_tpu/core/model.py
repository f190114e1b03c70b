"""Spleeter U-Net forward pass as a pure function over a params pytree.

Reference semantics (Executable/spleeter.c:111-301), re-derived for
`lax.conv_general_dilated` in NHWC/HWIO layouts:

- 6 encoder convs: 5x5, stride 2. The reference's im2col offset arithmetic
  (pad = padding + dilation - 1 = 2, hoffset/woffset = 2,
  Executable/spleeter.c:91,144-149 + Executable/im2col_dilated.c:10-33)
  resolves to input index `2*out + k - 1`, i.e. exact TF-SAME asymmetric
  padding (1, 2) per spatial dim for even input sizes.
- 6 decoder transposed convs: 5x5, stride 2, output_padding 1, offsets (1,1)
  (Executable/spleeter.c:150-155). The col2im scatter
  (Executable/im2col_dilated.c:42-65 with the extra -1 crop at :34-41)
  resolves to `out[2*in + k - 1] += x[in] * w[k]`, i.e. TF-SAME
  conv2d_transpose: lhs_dilation 2 with padding (3, 2) and a spatially
  flipped kernel.
- Final conv: 4x4, dilation 2, stride 1 (Executable/spleeter.c:156). The
  nonstandard effective-kernel formula `(d-1)*(k+1)+k = 9`
  (Executable/im2col_dilated.c:13) plus offsets (1,1) resolves to taps at
  {-3, -1, +1, +3}: a standard rhs_dilation-2 conv with padding (3, 3).
- Fusion order (Executable/spleeter.c:177-301): encoder
  `act(bn_scale * (conv + bias) + bn_shift)` with the PRE-activation
  `conv + bias` retained as the skip tensor; bottleneck bias-only; decoder
  `bn_scale * act(tconv + bias) + bn_shift` (activation BEFORE batch norm);
  skip concat is [skip, upsampled] along channels; mask =
  sigmoid(final_conv + bias).

Activations (Executable/spleeter.c:43-56,130-139): stem mode 0 (2-stem
subnet) uses leakyReLU(0.2) encoder / ReLU decoder; mode 1 (4-stem family)
uses ELU everywhere with inputs below -15 clamped to -1.

Input layout: the C code runs CHW planes of shape (2, timeStep, binLimit)
(Executable/main.c:468: magnitude[ch][time][bin]); here NHWC
(batch, time, bins, 2), the channels-last layout cuDNN takes directly.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from spleeterrt_tpu.config import STEM_MODE_2, STEM_MODE_4

# (Cin, Cout) per encoder layer (Executable/spleeter.c:144-149).
ENCODER_CHANNELS = ((2, 16), (16, 32), (32, 64), (64, 128), (128, 256), (256, 512))
# (Cin, Cout) per decoder layer; Cin includes the skip concat
# (Executable/spleeter.c:150-155).
DECODER_CHANNELS = ((512, 256), (512, 128), (256, 64), (128, 32), (64, 16), (32, 1))
FINAL_CHANNELS = (1, 2)

Params = dict[str, Any]

_DIMS = ("NHWC", "HWIO", "NHWC")


def init_params(key: jax.Array, dtype=jnp.float32) -> Params:
    """Random params with the blob's shapes; he-normal fan-in init."""
    params: Params = {}
    n_layers = len(ENCODER_CHANNELS) + len(DECODER_CHANNELS) + 1
    keys = jax.random.split(key, n_layers)
    ki = 0

    def conv_init(k, kh, kw, cin, cout):
        fan_in = kh * kw * cin
        return jax.random.normal(k, (kh, kw, cin, cout), dtype) * jnp.sqrt(2.0 / fan_in)

    for i, (cin, cout) in enumerate(ENCODER_CHANNELS, start=1):
        layer = {
            "w": conv_init(keys[ki], 5, 5, cin, cout),
            "b": jnp.zeros((cout,), dtype),
        }
        if i < 6:  # down6 (bottleneck) has no batch norm
            layer["bn_scale"] = jnp.ones((cout,), dtype)
            layer["bn_shift"] = jnp.zeros((cout,), dtype)
        params[f"down{i}"] = layer
        ki += 1
    for i, (cin, cout) in enumerate(DECODER_CHANNELS, start=1):
        params[f"up{i}"] = {
            "w": conv_init(keys[ki], 5, 5, cin, cout),
            "b": jnp.zeros((cout,), dtype),
            "bn_scale": jnp.ones((cout,), dtype),
            "bn_shift": jnp.zeros((cout,), dtype),
        }
        ki += 1
    params["up7"] = {
        "w": conv_init(keys[ki], 4, 4, *FINAL_CHANNELS),
        "b": jnp.zeros((FINAL_CHANNELS[1],), dtype),
    }
    return params


def _act_encoder(x: jax.Array, stem_mode: int) -> jax.Array:
    if stem_mode == STEM_MODE_2:
        return jnp.where(x >= 0, x, 0.2 * x)  # leakyReLU (spleeter.c:43-46)
    return _elu(x)


def _act_decoder(x: jax.Array, stem_mode: int) -> jax.Array:
    if stem_mode == STEM_MODE_2:
        return jnp.maximum(x, 0.0)  # ReLU (spleeter.c:47-50)
    return _elu(x)


def _elu(x: jax.Array) -> jax.Array:
    # Denormal guard: x < -15 -> -1 exactly (Executable/spleeter.c:51-56).
    # The upper clamp never changes the forward value (expm1(safe) is only
    # selected when x < 0) -- it keeps the BACKWARD finite: without it,
    # d(expm1)/dx = exp(safe) overflows to inf wherever x > ~88, and the
    # where-zeroed cotangent times inf is NaN (0 * inf), which killed
    # training the moment any pre-activation crossed 88 (round-5 fix).
    safe = jnp.clip(x, -15.0, 80.0)
    return jnp.where(x >= 0, x, jnp.where(x < -15.0, -1.0, jnp.expm1(safe)))


def fast_sigmoid(x: jax.Array) -> jax.Array:
    """Piecewise-linear sigmoid over 1025 knots on [-7, 7], clamped outside.

    Regenerates the reference exe's LUT behaviour (Executable/spleeter.c:30-42;
    the table there is sigmoid sampled at -7 + i*14/1024 with the last entry
    forced to 1) for bit-parity testing; the VST uses the exact sigmoid.
    """
    step = 14.0 / 1024.0
    idx = jnp.clip(jnp.floor((x + 7.0) / step), 0, 1023)
    x1 = -7.0 + step * idx
    y0 = jax.nn.sigmoid(x1)
    y1 = jnp.where(idx >= 1023, 1.0, jax.nn.sigmoid(x1 + step))
    y = y0 + (y1 - y0) / step * (x - x1)
    return jnp.where(x > 7.0, 1.0, jnp.where(x < -7.0, 0.0, y))


def _conv_same(x: jax.Array, w: jax.Array) -> jax.Array:
    """5x5 stride-2 conv with the reference's TF-SAME (1,2) padding."""
    return lax.conv_general_dilated(
        x, w, window_strides=(2, 2), padding=((1, 2), (1, 2)),
        dimension_numbers=_DIMS,
    )


def _tconv_same(x: jax.Array, w: jax.Array) -> jax.Array:
    """5x5 stride-2 TF-SAME transposed conv (out[2h + k - 1] += x[h] w[k])."""
    return lax.conv_general_dilated(
        x, w[::-1, ::-1], window_strides=(1, 1), padding=((3, 2), (3, 2)),
        lhs_dilation=(2, 2), dimension_numbers=_DIMS,
    )


# ---------------------------------------------------------------------------
# Exact rewrites of the two channel-poor ends of the U-Net. The stride-2
# input conv (Cin=2) becomes one stride-1 conv over space-to-depth packed
# input, and the lhs-dilated transposed convs of up5/up6 (Cout=16/1) become
# one stride-1 "subpixel" conv plus depth-to-space. Both are exact (see the
# derivations below and test_model.py::test_fast_layouts_exact), and both
# are faster than the canonical forms on the GPU and on the CPU (PERF.md:
# up5+up6 12.8 ms against 65.1 ms, enc1 4.0 ms against 5.8 ms at the 300 s
# 4-stem batch on an NVIDIA H100 80GB HBM3 at 400 W). The canonical
# `_conv_same`/`_tconv_same` stay as the oracle-checked references.
# ---------------------------------------------------------------------------


def _pack_tconv_kernel(w: jax.Array) -> jax.Array:
    """(5,5,Cin,Cout) -> (3,3,Cin,4*Cout) subpixel kernel.

    out[2h'+dp] = sum_j x[h'-j] W[2j+dp+1]: parity class dp uses taps
    {W[3],W[1]} (dp=0) / {W[4],W[2],W[0]} (dp=1) as a stride-1 3-kernel
    (zero-padded); the four (dp,dq) classes stack on the output channels.
    """
    cin, cout = w.shape[2], w.shape[3]
    idx = {0: [3, 1, None], 1: [4, 2, 0]}
    out = jnp.zeros((3, 3, cin, 4 * cout), w.dtype)
    for dp in (0, 1):
        for dq in (0, 1):
            for a in range(3):
                for b in range(3):
                    ia, ib = idx[dp][a], idx[dq][b]
                    if ia is None or ib is None:
                        continue
                    out = out.at[
                        a, b, :, (dp * 2 + dq) * cout : (dp * 2 + dq + 1) * cout
                    ].set(w[ia, ib])
    return out


def _tconv_subpixel(x: jax.Array, w: jax.Array) -> jax.Array:
    """== _tconv_same via one stride-1 conv + depth-to-space."""
    bsz, h, ww_, cin = x.shape
    cout = w.shape[3]
    y = lax.conv_general_dilated(
        x, _pack_tconv_kernel(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=_DIMS,
    )
    y = y.reshape(bsz, h, ww_, 2, 2, cout)
    return y.transpose(0, 1, 3, 2, 4, 5).reshape(bsz, 2 * h, 2 * ww_, cout)


def _pack_enc_kernel(w: jax.Array) -> jax.Array:
    """(5,5,Cin,Cout) -> (3,3,4*Cin,Cout) space-to-depth kernel.

    x index 2h'+kh-1 = 2g+dh with kh = 2(a-1)+dh+1: the stride-2 5x5 conv
    becomes a stride-1 3x3 conv over (dh,dw,ci)-packed input.
    """
    cin, cout = w.shape[2], w.shape[3]
    out = jnp.zeros((3, 3, 4 * cin, cout), w.dtype)
    for a in range(3):
        for b in range(3):
            for dh in (0, 1):
                for dw in (0, 1):
                    ia = 2 * (a - 1) + dh + 1
                    ib = 2 * (b - 1) + dw + 1
                    if not (0 <= ia < 5 and 0 <= ib < 5):
                        continue
                    out = out.at[
                        a, b, (dh * 2 + dw) * cin : (dh * 2 + dw + 1) * cin, :
                    ].set(w[ia, ib])
    return out


def _conv_same_s2d(x: jax.Array, w: jax.Array) -> jax.Array:
    """== _conv_same via space-to-depth packing + one stride-1 conv."""
    bsz, h, ww_, cin = x.shape
    xp = x.reshape(bsz, h // 2, 2, ww_ // 2, 2, cin)
    xp = xp.transpose(0, 1, 3, 2, 4, 5).reshape(bsz, h // 2, ww_ // 2, 4 * cin)
    return lax.conv_general_dilated(
        xp, _pack_enc_kernel(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=_DIMS,
    )


def _conv_encoder(x: jax.Array, w: jax.Array, layer: int) -> jax.Array:
    if layer == 1:  # Cin=2
        return _conv_same_s2d(x, w)
    return _conv_same(x, w)


def _tconv_decoder(x: jax.Array, w: jax.Array, layer: int) -> jax.Array:
    if layer >= 5:  # up5 (Cout=16), up6 (Cout=1)
        return _tconv_subpixel(x, w)
    return _tconv_same(x, w)


def _conv_dilated_final(x: jax.Array, w: jax.Array) -> jax.Array:
    """4x4 rhs_dilation-2 stride-1 conv, padding (3,3): taps at -3,-1,+1,+3."""
    return lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding=((3, 3), (3, 3)),
        rhs_dilation=(2, 2), dimension_numbers=_DIMS,
    )


def encoder_layer(
    ly: dict, x: jax.Array, layer: int, stem_mode: int, compute_dtype
) -> tuple[jax.Array, jax.Array]:
    """down<layer>: returns (pre-activation `conv + bias` skip, output).

    down1..down5: `act(bn_scale * (conv + bias) + bn_shift)`; down6 (the
    bottleneck) is bias-only (Executable/spleeter.c:177-238).
    """
    cast = lambda a: a.astype(compute_dtype)
    conv = _conv_encoder(x.astype(compute_dtype), cast(ly["w"]), layer) + cast(ly["b"])
    if "bn_scale" not in ly:
        return conv, conv
    out = _act_encoder(cast(ly["bn_scale"]) * conv + cast(ly["bn_shift"]), stem_mode)
    return conv, out


def decoder_layer(
    ly: dict, x: jax.Array, layer: int, stem_mode: int, compute_dtype
) -> jax.Array:
    """up<layer> (1..6): `bn_scale * act(tconv + bias) + bn_shift`
    (activation BEFORE batch norm, Executable/spleeter.c:239-288)."""
    cast = lambda a: a.astype(compute_dtype)
    y = _tconv_decoder(x.astype(compute_dtype), cast(ly["w"]), layer) + cast(ly["b"])
    return cast(ly["bn_scale"]) * _act_decoder(y, stem_mode) + cast(ly["bn_shift"])


def mask_layer(
    ly: dict, x: jax.Array, compute_dtype, sigmoid: str = "exact"
) -> jax.Array:
    """up7: sigmoid(final dilated conv + bias), logits promoted to fp32."""
    logits = _conv_dilated_final(
        x.astype(compute_dtype), ly["w"].astype(compute_dtype)
    ).astype(jnp.float32) + ly["b"].astype(jnp.float32)
    if sigmoid == "lut":
        return fast_sigmoid(logits)
    return jax.nn.sigmoid(logits)


@functools.partial(
    jax.jit, static_argnames=("stem_mode", "compute_dtype", "sigmoid")
)
def unet_forward(
    params: Params,
    magnitude: jax.Array,
    stem_mode: int = STEM_MODE_4,
    compute_dtype=jnp.float32,
    sigmoid: str = "exact",
) -> jax.Array:
    """Magnitude (batch, T, F, 2) -> soft mask (batch, T, F, 2) in [0, 1].

    T and F must be divisible by 64 (six stride-2 halvings). Everything runs
    in `compute_dtype` (bf16 for production, with fp32 accumulation in the
    convs); only the final logits are promoted to fp32 for the sigmoid.
    fp32 `compute_dtype` gives the oracle-parity path.
    """
    x = magnitude
    skips = []
    for i in range(1, 7):
        conv, x = encoder_layer(params[f"down{i}"], x, i, stem_mode, compute_dtype)
        skips.append(conv)
    for i in range(1, 7):
        y = decoder_layer(params[f"up{i}"], x, i, stem_mode, compute_dtype)
        # concat [skip, upsampled]; skips are pre-BN/act conv outputs
        # (spleeter.c:239-288, README "Fast neural network inference").
        x = jnp.concatenate([skips[5 - i], y], axis=-1) if i < 6 else y
    return mask_layer(params["up7"], x, compute_dtype, sigmoid)


def multi_stem_forward(
    stacked_params: Params,
    magnitude: jax.Array,
    stem_mode: int = STEM_MODE_4,
    compute_dtype=jnp.float32,
    sigmoid: str = "exact",
) -> jax.Array:
    """Run S stacked U-Nets over one magnitude batch -> (S, batch, T, F, 2).

    The reference runs one net per pthread (VST/Source/Spleeter4Stems.c:135,
    TASK_NB=5); here the stem axis is a vmap, so XLA batches all stems into
    the same convolutions.
    """
    return jax.vmap(
        lambda p: unet_forward(p, magnitude, stem_mode, compute_dtype, sigmoid)
    )(stacked_params)
