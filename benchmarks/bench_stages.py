"""Stage-by-stage times of the 4-stem offline pipeline on one GPU.

Each stage of `separate.separate_4stem` at the VST widths (bin limit 1536,
time step 256, bf16, 300 s of audio by default) runs as its own jitted
function: compiled and warmed, then timed `--reps` times with
`block_until_ready` (median). Beside each time it prints the stage's
roofline bound on the card: the larger of its minimum bytes at the peak
bandwidth and its FLOPs at the peak bf16 rate (`PEAK_BW`, `bench.PEAK_BF16`).

Stages: stft, spec_to_tiles, unet (and its layer groups), mask_relayout,
masked_irfft (mask multiply + inverse FFT + synthesis window),
masked_irfft_plus_ola (the whole masked iSTFT) and e2e (the whole graph).

Usage: python benchmarks/bench_stages.py [--seconds 300] [--reps 5]
Prints one JSON object; exits with code 2 when JAX's backend is not "gpu".
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

# Peak device-memory bandwidth per device kind (NVIDIA H100 SXM data sheet).
PEAK_BW = {"NVIDIA H100 80GB HBM3": 3.35e12}

LAYER_GROUPS = {
    "enc1": ("down1",),
    "enc2_6": ("down2", "down3", "down4", "down5", "down6"),
    "dec1_4": ("up1", "up2", "up3", "up4"),
    "dec5_6": ("up5", "up6"),
    "head": ("up7",),
}


def layer_shapes(t: int, f: int):
    """{layer: (input HWC, output HWC, flops)} of one U-Net tile."""
    from spleeterrt_tpu.core import model

    out = {}
    h, w = t, f
    for i, (cin, cout) in enumerate(model.ENCODER_CHANNELS, start=1):
        out[f"down{i}"] = ((h, w, cin), (h // 2, w // 2, cout),
                           2.0 * (h // 2) * (w // 2) * cout * 25 * cin)
        h, w = h // 2, w // 2
    for i, (cin, cout) in enumerate(model.DECODER_CHANNELS, start=1):
        out[f"up{i}"] = ((h, w, cin), (2 * h, 2 * w, cout),
                         2.0 * h * w * cin * 25 * cout)
        h, w = 2 * h, 2 * w
    out["up7"] = ((h, w, 1), (h, w, 2), 2.0 * h * w * 2 * 16)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from spleeterrt_tpu.config import STEM_MODE_4, SeparatorConfig
    from spleeterrt_tpu.core import model, separate, transform

    if not bench.require_gpu():
        return 2
    device = bench.device_info()
    kind = device["kind"]
    peak, bw = bench.peak_bf16(kind), PEAK_BW[kind]

    cfg = SeparatorConfig(
        bin_limit=1536, time_step=256, num_stems=4, compute_dtype=jnp.bfloat16
    )
    tcfg = cfg.transform
    s, t, f = 4, cfg.time_step, cfg.bin_limit
    stacked = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[model.init_params(jax.random.PRNGKey(i)) for i in range(s)],
    )
    rng = np.random.default_rng(0)
    n = int(args.seconds * 44100)
    audio = jnp.asarray(rng.standard_normal((2, n)) * 0.3, jnp.float32)
    padded = jax.device_put(transform.pad_offline(audio, tcfg))
    data_size = padded.shape[-1]
    uw = jnp.asarray(separate.OUT_BAND_4)

    stft = jax.jit(lambda p: transform.stft(p, tcfg, data_size))
    spec = jax.block_until_ready(stft(padded))
    nf = spec.shape[-2]
    nt = separate.num_tiles(nf, t)
    to_tiles = jax.jit(lambda sp: separate.spec_to_tiles(sp, cfg))
    tiles = jax.block_until_ready(to_tiles(spec))
    unet = jax.jit(
        lambda p, x: model.multi_stem_forward(p, x, STEM_MODE_4, jnp.bfloat16)
    )
    masks_t = jax.block_until_ready(unet(stacked, tiles))
    relayout = jax.jit(
        lambda m: jax.vmap(separate.tiles_to_frames, in_axes=(0, None))(m, nf)
    )
    masks = jax.block_until_ready(relayout(masks_t))

    def masked_frames(sp, m):
        def one(mask, w):
            in_band = sp[..., :f] * mask.astype(sp.real.dtype)
            oob = sp[..., f:] * w.astype(sp.real.dtype)
            full = jnp.concatenate([in_band, oob], axis=-1)
            return jnp.fft.irfft(full, n=tcfg.fft_size, axis=-1) * (
                transform.synthesis_window(tcfg)
            )
        return jax.vmap(one)(m, uw)

    masked_irfft = jax.jit(masked_frames)
    masked_istft = jax.jit(
        lambda sp, m: jax.vmap(lambda fr: transform.overlap_add(fr, tcfg))(
            masked_frames(sp, m)
        )
    )
    e2e = jax.jit(lambda p, a: separate.separate_4stem(p, a, cfg))

    shapes = layer_shapes(t, f)
    unet_flops = s * nt * sum(v[2] for v in shapes.values())
    act_bytes = s * nt * 2 * sum(
        np.prod(v[0]) + np.prod(v[1]) for v in shapes.values()
    )  # bf16: every layer reads its input and writes its output once
    c64, f32 = 8, 4
    stages = {
        "stft": (stft, (padded,), 2 * data_size * f32 + 2 * nf * tcfg.num_bins * c64, 0.0),
        "spec_to_tiles": (to_tiles, (spec,), 2 * nf * f * (c64 + f32), 0.0),
        "unet": (unet, (stacked, tiles), act_bytes, unet_flops),
        "mask_relayout": (relayout, (masks_t,), 2 * s * 2 * nt * t * f * f32, 0.0),
        "masked_irfft": (masked_irfft, (spec, masks),
                         2 * nf * tcfg.num_bins * c64 + s * 2 * nf * f * f32
                         + s * 2 * nf * tcfg.fft_size * f32, 0.0),
        "masked_irfft_plus_ola": (masked_istft, (spec, masks),
                                  2 * nf * tcfg.num_bins * c64 + s * 2 * nf * f * f32
                                  + s * 2 * nf * tcfg.hop * f32, 0.0),
        "e2e": (e2e, (stacked, padded),
                2 * data_size * f32 + s * 2 * nf * tcfg.hop * f32, unet_flops),
    }

    # U-Net layer groups, each on random inputs of its real shape.
    def group_fn(names):
        def run(p, x):
            def one(pp, y):
                for name in names:
                    i = int(name[-1])
                    if name.startswith("down"):
                        _, y = model.encoder_layer(pp[name], y, i, STEM_MODE_4, jnp.bfloat16)
                    elif name == "up7":
                        y = model.mask_layer(pp[name], y, jnp.bfloat16)
                    else:
                        y = model.decoder_layer(pp[name], y, i, STEM_MODE_4, jnp.bfloat16)
                        if name != names[-1]:
                            y = jnp.concatenate([y, y], axis=-1)  # skip concat
                return y
            return jax.vmap(one)(p, x)
        return run

    results = {"seconds": args.seconds, "frames": nf, "tiles": nt}
    for name, (fn, fargs, nbytes, flops) in stages.items():
        sec = bench.median_seconds(fn, *fargs, reps=args.reps)
        bound = max(nbytes / bw, flops / peak)
        results[name] = {
            "ms": sec * 1e3,
            "bound_ms": bound * 1e3,
            "bound_by": "flops" if flops / peak > nbytes / bw else "bytes",
            "roofline_share": bound / sec,
        }
    for group, names in LAYER_GROUPS.items():
        hin = shapes[names[0]][0]
        x = jnp.asarray(
            np.abs(rng.standard_normal((s, nt) + hin)), jnp.bfloat16
        )
        flops = s * nt * sum(shapes[nm][2] for nm in names)
        sec = bench.median_seconds(jax.jit(group_fn(names)), stacked, x, reps=args.reps)
        results[f"unet_{group}"] = {
            "ms": sec * 1e3,
            "flops_bound_ms": flops / peak * 1e3,
        }

    results["device"] = device
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
