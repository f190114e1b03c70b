"""Command-line offline separation, mirroring the reference CLI surface.

Reference: `SpleeterRT spawnNthreads timeStep analyseBinLimit stems audioFile`
(Executable/main.c:704-748), with arg clamping (timeStep >= 64,
analyseBinLimit in [512, 2048]) and stage timing printfs
(Executable/main.c:772,783,825). The reference's worker threads become one
batched pass over every spectrogram tile on the device.

Stem file naming matches the reference (`<name>_Vocal.wav`,
`<name>_Accompaniment.wav`, `<name>_Drum.wav`, Executable/main.c:812-965)
plus `<name>_Bass.wav` for the 4-stem graph.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

STEM_FILENAMES = {
    "vocals": "Vocal",
    "accompaniment": "Accompaniment",
    "drums": "Drum",
    "bass": "Bass",
    "piano": "Piano",
    "other": "Other",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spleeterrt-tpu",
        description="Spleeter source separation in JAX (offline CLI).",
    )
    p.add_argument("audio", help="input audio file (WAV; FLAC/MP3 via ffmpeg)")
    p.add_argument("--stems", type=int, default=2, choices=(2, 3, 4, 5))
    p.add_argument("--time-step", type=int, default=512,
                   help="spectrogram tile height in frames (default 512)")
    p.add_argument("--bin-limit", type=int, default=1024,
                   help="frequency bins seen by the U-Net (default 1024)")
    p.add_argument("--weights", default=None,
                   help="weights source: quantized 2-subnet model file "
                        "(2/3 stems), a directory with the four VST .dat "
                        "blobs (4 stems), or npz checkpoints")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights (smoke/benchmark; model.7z is not "
                        "distributable)")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--output-rate", default="44100",
                   help="output sample rate: a number, or 'input' to "
                        "resample stems back to the source rate")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bfloat16 U-Net compute (default)")
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace to DIR")
    return p


def _clamp_args(args) -> None:
    if args.time_step < 64:
        print("timeStep clamp to 64")
        args.time_step = 64
    args.time_step = (args.time_step + 63) // 64 * 64
    if args.bin_limit < 512:
        print("analyseBinLimit clamp to 512")
        args.bin_limit = 512
    if args.bin_limit > 2048:
        print("Analysis bin limit reached, clamp value to 2048")
        args.bin_limit = 2048
    args.bin_limit = args.bin_limit // 64 * 64


def _load_weights(args, cfg):
    """Returns kwargs for separate.separate()."""
    import jax

    from spleeterrt_tpu.core import model, weights

    if args.random_weights or args.weights is None:
        if not args.random_weights:
            print("no --weights given; using random weights")
        key = jax.random.PRNGKey(args.seed)
        keys = jax.random.split(key, 4)
        ps = [model.init_params(k) for k in keys]
        if cfg.num_stems == 2:
            return {"params": ps[0]}
        if cfg.num_stems == 3:
            return {"params4": ps[0], "params2": ps[1]}
        if cfg.num_stems == 5:
            keys5 = jax.random.split(key, 5)
            ps = [model.init_params(k) for k in keys5]
        return {"stacked_params": weights.stack_params(ps)}

    src = args.weights
    if os.path.isdir(src):
        if cfg.num_stems == 4:
            ps = []
            for stem in cfg.stem_names:
                path = os.path.join(src, weights.VST_BLOB_FILENAMES[stem])
                ps.append(weights.load_coeff_file(path))
            return {"stacked_params": weights.stack_params(ps)}
        raise SystemExit("--weights dir is only for 4-stem (.dat blobs)")
    if src.endswith(".npz"):
        p = weights.load_npz(src)
        if cfg.num_stems != 2:
            raise SystemExit("single npz supports --stems 2 only")
        return {"params": p}
    # quantized exe model: raw fp16 2-subnet file
    with open(src, "rb") as f:
        p4, p2 = weights.load_quantized_model(f.read())
    if cfg.num_stems == 2:
        return {"params": p2}
    if cfg.num_stems == 3:
        return {"params4": p4, "params2": p2}
    raise SystemExit("quantized model supports 2/3 stems")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _clamp_args(args)

    # Fail fast on undecodable input before any device/weight work.
    from spleeterrt_tpu.io import audio as _audio_check

    if not os.path.exists(args.audio):
        raise SystemExit(f"no such file: {args.audio}")
    try:
        _audio_check.check_decodable(args.audio)
    except _audio_check.UnsupportedFormatError as e:
        raise SystemExit(str(e))

    import jax
    import jax.numpy as jnp

    from spleeterrt_tpu.config import SeparatorConfig
    from spleeterrt_tpu.core import platform, separate
    from spleeterrt_tpu.io import audio as audio_io, resample

    platform.enable_compile_cache()
    cfg = SeparatorConfig(
        bin_limit=args.bin_limit,
        time_step=args.time_step,
        num_stems=args.stems,
        compute_dtype=jnp.bfloat16 if args.bf16 else jnp.float32,
    )
    print(f"spleeterrt-tpu: {len(jax.devices())} device(s), "
          f"{platform.backend()} backend")

    t0 = time.perf_counter()
    try:
        data = audio_io.load_audio(args.audio)
    except _audio_check.UnsupportedFormatError as e:
        raise SystemExit(str(e))
    samples = data.samples
    if data.sample_rate != 44100:
        samples = resample.resample(samples, data.sample_rate, 44100)
    if samples.shape[0] == 1:
        samples = np.repeat(samples, 2, axis=0)
    elif samples.shape[0] > 2:
        samples = samples[:2]
    print(f"Audio load + resample: {time.perf_counter() - t0:.3f} s "
          f"({samples.shape[1] / 44100.0:.1f} s of audio)")

    kwargs = _load_weights(args, cfg)

    if args.profile:
        jax.profiler.start_trace(args.profile)
    t0 = time.perf_counter()
    stems = separate.separate(samples, cfg=cfg, **kwargs)
    jax.block_until_ready(stems)
    dt = time.perf_counter() - t0
    if args.profile:
        jax.profiler.stop_trace()
    rtf = samples.shape[1] / 44100.0 / dt
    print(f"Separation ({cfg.num_stems} stems): {dt:.3f} s "
          f"({rtf:.1f}x real time, includes compile)")

    out_rate = 44100
    if args.output_rate == "input":
        out_rate = data.sample_rate
    else:
        out_rate = int(args.output_rate)

    base = os.path.splitext(os.path.basename(args.audio))[0]
    os.makedirs(args.output_dir, exist_ok=True)
    t0 = time.perf_counter()
    for stem, x in stems.items():
        out = os.path.join(
            args.output_dir, f"{base}_{STEM_FILENAMES[stem]}.wav"
        )
        y = np.asarray(x)
        if out_rate != 44100:
            y = resample.resample(y, 44100, out_rate)
        audio_io.write_wav(out, y, out_rate, fmt="float32")
        print(f"Saved {out}")
    print(f"Save: {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
