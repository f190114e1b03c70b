"""NumPy oracle reproducing the reference C numerics, written from spec.

This deliberately follows the C code's *conventions* (Hartley planes, im2col
index arithmetic, scale chain) rather than the framework's simplifications
(plain rFFT, TF-SAME convs), so agreement between the two is a real check of
the derivations in spleeterrt_tpu/core/*.py. Sources of the conventions:

- STFT/iSTFT scale chain and Hartley packing: Executable/stftFix.c
- im2col/col2im index arithmetic: Executable/im2col_dilated.c
- layer geometry / fusion order: Executable/spleeter.c:111-301
- offline driver tiling and mask application: Executable/main.c:444-674
- stem graphs: Executable/main.c:779-970

Everything is float64 internally unless noted; callers compare with
tolerances covering the fp32 reference gap.
"""

from __future__ import annotations

import numpy as np

FFTSIZE = 4096
LAP = 4
HOP = FFTSIZE // LAP
HALFWNDLEN = FFTSIZE // 2 + 1


def hann_offset(n: int) -> np.ndarray:
    i = np.arange(n)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * (i + 0.5) / n))


def _fht(x: np.ndarray) -> np.ndarray:
    """Fast Hartley transform along the last axis: sum x * (cos + sin)."""
    f = np.fft.fft(x, axis=-1)
    return f.real - f.imag


def stft_planes(data: np.ndarray, data_size: int):
    """One channel (data_size,) -> (re, im) planes (n_frames, HALFWNDLEN).

    Follows Executable/stftFix.c:363-495: preWindow = hann/N * 2/LAP, frames
    at 0..rangeM step HOP plus one zero-padded tail frame, Hartley unpack
    re = H[i] + H[N-i], im = H[i] - H[N-i], DC doubled, rows beyond the
    computed range left zero.
    """
    pre_window = hann_offset(FFTSIZE) / FFTSIZE * (2.0 / LAP)
    n_out = -(-data_size // HOP)
    range_m = ((data_size - FFTSIZE + HOP // LAP) // HOP) * HOP
    n_comp = range_m // HOP + 1
    x = np.zeros(range_m + FFTSIZE)
    take = min(data_size, x.size)
    x[:take] = data[:take]
    re = np.zeros((n_out, HALFWNDLEN))
    im = np.zeros((n_out, HALFWNDLEN))
    for f in range(n_comp):
        frame = x[f * HOP : f * HOP + FFTSIZE] * pre_window
        h = _fht(frame)
        re[f, 0] = h[0] * 2.0
        sym = h[FFTSIZE - np.arange(1, HALFWNDLEN)]
        re[f, 1:] = h[1:HALFWNDLEN] + sym
        im[f, 1:] = h[1:HALFWNDLEN] - sym
    return re, im


def istft_planes(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """(n_frames, HALFWNDLEN) planes -> time signal, per stftFix.c:496-579.

    postWindow = hann * 4/3 * 0.5 (LLCreatePostWindowFloat then the extra
    0.5 at InitSTFT, Executable/stftFix.c:310-312).
    """
    n_frames = re.shape[0]
    post_window = hann_offset(FFTSIZE) * (4.0 / 3.0) * 0.5
    out = np.zeros(n_frames * HOP + (FFTSIZE - HOP))
    for f in range(n_frames):
        b = np.zeros(FFTSIZE)
        b[0] = re[f, 0]
        b[1:HALFWNDLEN] = re[f, 1:] + im[f, 1:]
        b[FFTSIZE - np.arange(1, HALFWNDLEN)] = re[f, 1:] - im[f, 1:]
        frame = _fht(b)
        out[f * HOP : f * HOP + FFTSIZE] += frame * post_window
    return out


# ---------------------------------------------------------------------------
# Conv oracle: direct index-arithmetic evaluation of the reference layers.
# ---------------------------------------------------------------------------


def conv5x5_s2(x: np.ndarray, w: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """Encoder conv: x (Cin,H,W), w (Cout,Cin,5,5) -> (Cout,H/2,W/2).

    Input index = 2*out + k - 1 (pad (1,2)); see im2col_dilated.c:10-33 with
    pad=2, offsets (2,2), dilation 1.
    """
    cin, hh, ww = x.shape
    cout = w.shape[0]
    oh, ow = (hh - 1) // 2 + 1, (ww - 1) // 2 + 1
    xp = np.zeros((cin, hh + 3, ww + 3))
    xp[:, 1 : 1 + hh, 1 : 1 + ww] = x
    out = np.zeros((cout, oh, ow))
    for kh in range(5):
        for kw in range(5):
            patch = xp[:, kh : kh + 2 * oh : 2, kw : kw + 2 * ow : 2]
            out += np.einsum("chw,oc->ohw", patch, w[:, :, kh, kw])
    return out + bias[:, None, None]


def tconv5x5_s2(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Decoder transposed conv: x (Cin,H,W), w (Cin,Cout,5,5) -> (Cout,2H,2W).

    Scatter out[2h + kh - 1] += x[h] * w[kh] (col2im_dilated_cpu with pad=2,
    offsets (1,1), plus the -1 crop in col2im_add_pixel_dilated).
    """
    cin, hh, ww = x.shape
    cout = w.shape[1]
    oh, ow = 2 * hh, 2 * ww
    acc = np.zeros((cout, oh + 4, ow + 4))
    for kh in range(5):
        for kw in range(5):
            contrib = np.einsum("chw,co->ohw", x, w[:, :, kh, kw])
            acc[:, kh : kh + 2 * hh : 2, kw : kw + 2 * ww : 2] += contrib
    # positions 2h + kh - 1 + 1 = 2h + kh in the padded array; crop 1..oh+1
    return acc[:, 1 : 1 + oh, 1 : 1 + ow]


def conv4x4_d2(x: np.ndarray, w: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """Final conv: x (1,H,W), w (2,1,4,4) -> (2,H,W); taps at -3,-1,+1,+3."""
    cin, hh, ww = x.shape
    cout = w.shape[0]
    xp = np.zeros((cin, hh + 6, ww + 6))
    xp[:, 3 : 3 + hh, 3 : 3 + ww] = x
    out = np.zeros((cout, hh, ww))
    for kh in range(4):
        for kw in range(4):
            patch = xp[:, 2 * kh : 2 * kh + hh, 2 * kw : 2 * kw + ww]
            out += np.einsum("chw,oc->ohw", patch, w[:, :, kh, kw])
    return out + bias[:, None, None]


def leaky_relu(x):
    return np.where(x >= 0, x, 0.2 * x)


def relu(x):
    return np.maximum(x, 0.0)


def elu(x):
    return np.where(x >= 0, x, np.where(x < -15.0, -1.0, np.expm1(np.maximum(x, -15.0))))


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


ENC = ((2, 16), (16, 32), (32, 64), (64, 128), (128, 256), (256, 512))
DEC = ((512, 256), (512, 128), (256, 64), (128, 32), (64, 16), (32, 1))


def unpack_blob(blob: bytes) -> dict:
    """Raw fp32 spleeterCoeff blob -> dict of C-layout arrays."""
    flat = np.frombuffer(blob, dtype="<f4").astype(np.float64)
    fields = {}
    pos = 0

    def take(n, shape):
        nonlocal pos
        a = flat[pos : pos + n].reshape(shape)
        pos += n
        return a

    for i, (cin, cout) in enumerate(ENC, start=1):
        fields[f"down{i}_w"] = take(25 * cin * cout, (cout, cin, 5, 5))
        fields[f"down{i}_b"] = take(cout, (cout,))
        if i < 6:
            bn = take(2 * cout, (2, cout))
            fields[f"down{i}_shift"], fields[f"down{i}_scale"] = bn[0], bn[1]
    for i, (cin, cout) in enumerate(DEC, start=1):
        fields[f"up{i}_w"] = take(25 * cin * cout, (cin, cout, 5, 5))
        fields[f"up{i}_b"] = take(cout, (cout,))
        bn = take(2 * cout, (2, cout))
        fields[f"up{i}_shift"], fields[f"up{i}_scale"] = bn[0], bn[1]
    fields["up7_w"] = take(32, (2, 1, 4, 4))
    fields["up7_b"] = take(2, (2,))
    assert pos == flat.size
    return fields


def encoder_layer(fields: dict, x: np.ndarray, i: int, stem_mode: int):
    """down<i> on (Cin,H,W) -> (pre-activation skip, output).

    act(scale*(conv+bias)+shift) for down1..down5; the bottleneck down6 is
    bias-only (Executable/spleeter.c:177-238).
    """
    act_e = leaky_relu if stem_mode == 0 else elu
    conv = conv5x5_s2(x, fields[f"down{i}_w"], fields[f"down{i}_b"])
    if i == 6:
        return conv, conv
    out = act_e(
        fields[f"down{i}_scale"][:, None, None] * conv
        + fields[f"down{i}_shift"][:, None, None]
    )
    return conv, out


def decoder_layer(fields: dict, x: np.ndarray, i: int, stem_mode: int):
    """up<i> (1..6) on (Cin,H,W): scale*act(tconv+bias)+shift."""
    act_d = relu if stem_mode == 0 else elu
    y = tconv5x5_s2(x, fields[f"up{i}_w"]) + fields[f"up{i}_b"][:, None, None]
    return (
        fields[f"up{i}_scale"][:, None, None] * act_d(y)
        + fields[f"up{i}_shift"][:, None, None]
    )


def mask_layer(fields: dict, x: np.ndarray) -> np.ndarray:
    """up7: sigmoid(final dilated conv + bias) (exact sigmoid, VST variant)."""
    return sigmoid(conv4x4_d2(x, fields["up7_w"], fields["up7_b"]))


def unet(fields: dict, mag: np.ndarray, stem_mode: int) -> np.ndarray:
    """Full U-Net forward on (2, T, F) magnitude -> (2, T, F) mask.

    Fusion order per Executable/spleeter.c:177-301: encoder
    act(scale*(conv+bias)+shift) with pre-activation skips; bottleneck
    bias-only; decoder scale*act(x+bias)+shift; concat [skip, up];
    final sigmoid(conv+bias). Uses the exact sigmoid (VST variant).
    """
    x = mag
    skips = []
    for i in range(1, 7):
        conv, x = encoder_layer(fields, x, i, stem_mode)
        skips.append(conv)
    for i in range(1, 7):
        y = decoder_layer(fields, x, i, stem_mode)
        x = np.concatenate([skips[5 - i], y], axis=0) if i < 6 else y
    return mask_layer(fields, x)


def offline_separate_2stem(
    fields: dict,
    audio: np.ndarray,
    n_pcm: int,
    bin_limit: int,
    time_step: int,
    unaffected_weight: float = 0.1,
):
    """Full 2-stem offline path on (2, n_pcm) audio (Executable/main.c:779-808).

    Returns (vocal, accompaniment), each (2, n_pcm).
    """
    readcount = -(-n_pcm // FFTSIZE)
    final_size = FFTSIZE * readcount + 2 * FFTSIZE
    padded = np.zeros((2, final_size))
    padded[:, FFTSIZE : FFTSIZE + n_pcm] = audio[:, :n_pcm]

    planes = [stft_planes(padded[ch], final_size) for ch in range(2)]
    re = np.stack([planes[0][0], planes[1][0]])  # (2, n_frames, bins)
    im = np.stack([planes[0][1], planes[1][1]])
    n_frames = re.shape[1]

    flr = n_frames // time_step
    for tile in range(flr + 1):
        lo = tile * time_step
        hi = min(lo + time_step, n_frames)
        if hi <= lo and tile == flr:
            hi = lo  # zero tail tile still runs in C; masks hit no frames
        mag = np.zeros((2, time_step, bin_limit))
        mag[:, : hi - lo] = (
            np.hypot(re[:, lo:hi, :bin_limit], im[:, lo:hi, :bin_limit]) * FFTSIZE
        )
        mask = unet(fields, mag, stem_mode=0)[:, : hi - lo]
        re[:, lo:hi, :bin_limit] *= mask
        im[:, lo:hi, :bin_limit] *= mask
        re[:, lo:hi, bin_limit:] *= unaffected_weight
        im[:, lo:hi, bin_limit:] *= unaffected_weight

    vocal = np.stack([istft_planes(re[ch], im[ch]) for ch in range(2)])
    acc = padded - vocal[:, :final_size]
    sl = slice(FFTSIZE, FFTSIZE + n_pcm)
    return vocal[:, sl], acc[:, sl]
