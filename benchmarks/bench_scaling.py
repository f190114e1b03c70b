"""Scaling of the time-sharded 4-stem pipeline over the visible GPUs.

Measures samples/s of `parallel.timeshard.separate_4stem_timesharded_padded`
at 1, 2, 4, ... devices of one host and the scaling efficiency against one
device. With `--virtual N` it instead runs a tiny configuration on N virtual
CPU devices: a functional check of the sharded program whose times mean
nothing.

Usage: python benchmarks/bench_scaling.py [--seconds 60] [--virtual 8]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (functional check)")
    ap.add_argument("--stem-parallel", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        )
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from spleeterrt_tpu.config import SeparatorConfig
    from spleeterrt_tpu.core import model
    from spleeterrt_tpu.parallel import mesh as pmesh, timeshard

    if args.virtual:
        cfg = SeparatorConfig(
            bin_limit=512, time_step=64, num_stems=4,
            compute_dtype=jnp.float32,
        )
        device = {"platform": "cpu", "count": len(jax.devices())}
    else:
        if not bench.require_gpu():
            return 2
        device = bench.device_info()
        cfg = SeparatorConfig(
            bin_limit=1536, time_step=256, num_stems=4,
            compute_dtype=jnp.bfloat16,
        )
    params4 = [model.init_params(jax.random.PRNGKey(i)) for i in range(4)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *params4)

    n = int(args.seconds * 44100)
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((2, n)) * 0.3, jnp.float32)

    devices = jax.devices()
    results = {}
    counts = [d for d in (1, 2, 4, 8, len(devices)) if d <= len(devices)]
    for nd in sorted(set(counts)):
        m = pmesh.make_mesh(devices[:nd], stem_parallel=min(args.stem_parallel, nd))
        sec = bench.median_seconds(
            timeshard.separate_4stem_timesharded_padded, stacked, audio, cfg, m,
            reps=args.reps,
        )
        sps = n / sec
        results[nd] = sps
        eff = sps / (results[1] * nd) if 1 in results and nd > 1 else 1.0
        print(json.dumps({
            "devices": nd,
            "samples_per_sec": sps,
            "rtf": sps / 44100,
            "scaling_efficiency": eff,
            "functional_check": bool(args.virtual),
            "device": device,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
