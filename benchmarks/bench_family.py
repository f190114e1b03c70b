"""Real-time factor of every offline stem-graph family on one GPU.

The reference CLI's modes are 2/3/4(/5)-stem (Executable/main.c:845-970);
bench.py records the 4-stem number. This measures all four graphs at the
VST widths (bin limit 1536, time step 256, bf16) on the same workload.

Prints one JSON line per family: {"metric": "rtf_<N>stem_44k1", ...}.

Usage: python benchmarks/bench_family.py [--seconds 300] [--reps 5]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

SR = 44100


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from spleeterrt_tpu.config import SeparatorConfig
    from spleeterrt_tpu.core import model, separate, transform

    if not bench.require_gpu():
        return 2
    device = bench.device_info()
    cfg = SeparatorConfig(
        bin_limit=1536, time_step=256, num_stems=4, compute_dtype=jnp.bfloat16
    )
    params = [model.init_params(jax.random.PRNGKey(i)) for i in range(5)]
    stack = lambda ps: jax.tree.map(lambda *xs: jnp.stack(xs), *ps)

    n = int(args.seconds * SR)
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((2, n)) * 0.3, jnp.float32)
    padded = jax.device_put(transform.pad_offline(audio, cfg.transform))

    graphs = {
        "2stem": (separate.separate_2stem, (params[0], padded, cfg)),
        "3stem": (separate.separate_3stem, (params[0], params[1], padded, cfg)),
        "4stem": (separate.separate_4stem, (stack(params[:4]), padded, cfg)),
        "5stem": (
            separate.separate_nstem,
            (stack(params), padded, cfg, separate.OUT_BAND_5),
        ),
    }
    for name, (fn, fargs) in graphs.items():
        sec = bench.median_seconds(fn, *fargs, reps=args.reps)
        print(json.dumps({
            "metric": f"rtf_{name}_44k1",
            "value": args.seconds / sec,
            "unit": "x_realtime_per_chip",
            "dispatch_ms": sec * 1e3,
            "device": device,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
