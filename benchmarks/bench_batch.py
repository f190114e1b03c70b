"""Multi-track batched separation on one GPU: samples/s and MFU vs batch.

Many tracks per dispatch amortize the per-dispatch cost of the reference's
one-song CLI (Executable/main.c:444-674). Measures
`parallel.mesh.make_batch_fn` (one-device mesh) at B tracks per dispatch,
VST 4-stem config, bf16.

Per config prints one JSON line: audio samples/s, total real-time factor,
the dispatch time, and MFU (analytical pipeline FLOPs -- bench._pipeline_flops,
the U-Net convs + FFT cost -- over wall time over bench.PEAK_BF16), plus the
device block.

Usage: python benchmarks/bench_batch.py [--reps 5] [--configs 1:60,4:60]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

SR = 44100
# (tracks per dispatch, seconds per track).
CONFIGS = [(1, 60.0), (4, 60.0), (16, 30.0), (32, 15.0)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--configs", type=str, default=None,
                    help="comma list like 1:60,16:60")
    args = ap.parse_args()
    configs = CONFIGS
    if args.configs:
        configs = [
            (int(b), float(s))
            for b, s in (c.split(":") for c in args.configs.split(","))
        ]

    import jax
    import jax.numpy as jnp
    import numpy as np

    from spleeterrt_tpu.config import SeparatorConfig
    from spleeterrt_tpu.core import model, transform
    from spleeterrt_tpu.parallel import mesh as mesh_mod

    if not bench.require_gpu():
        return 2
    device = bench.device_info()
    peak = bench.peak_bf16(device["kind"])
    cfg = SeparatorConfig(
        bin_limit=1536, time_step=256, num_stems=4, compute_dtype=jnp.bfloat16
    )
    params4 = [model.init_params(jax.random.PRNGKey(i)) for i in range(4)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *params4)
    mesh = mesh_mod.make_mesh(jax.devices()[:1])
    batch_fn, _ = mesh_mod.make_batch_fn(cfg, mesh, 4)
    rng = np.random.default_rng(0)

    for b, seconds in configs:
        n = int(seconds * SR)
        tracks = jnp.asarray(rng.standard_normal((b, 2, n)) * 0.3, jnp.float32)
        padded = jax.device_put(transform.pad_offline(tracks, cfg.transform))
        sec = bench.median_seconds(batch_fn, stacked, padded, reps=args.reps)
        flops = b * bench._pipeline_flops(seconds, cfg, 4)
        total_audio = b * seconds
        print(json.dumps({
            "metric": f"batch_B{b}_L{seconds:g}s",
            "value": total_audio * SR / sec,
            "unit": "audio_samples_per_s_per_chip",
            "rtf": total_audio / sec,
            "dispatch_ms": sec * 1e3,
            "mfu_pct": 100.0 * flops / sec / peak,
            "device": device,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
