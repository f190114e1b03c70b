"""Benchmark: 4-stem offline separation real-time factor on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"marginal_rtf", "mfu_pct", "device"}. The device block is what JAX reports
(platform, device kind, count) and the card's name and power limit from
nvidia-smi. The script exits with code 2 when JAX's backend is not "gpu",
and raises on a device kind missing from `PEAK_BF16`.

Baseline: the reference separates 14 s of audio in ~600 ms on a desktop CPU
with MKL (README.MD "Fast neural network inference"), i.e. ~23.3x real time.

Workload: 300 s of audio per dispatch at the VST 4-stem widths (bin limit
1536, time step 256, bf16). Each size is compiled and warmed, then timed
`REPS` times with `block_until_ready`; the value is the median. The
marginal rate -- the slope between the 300 s and the 150 s dispatch, which
cancels every fixed per-call cost -- is reported alongside.

Usage: python bench.py
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

BASELINE_RTF = 14.0 / 0.6  # reference README claim
SECONDS = 300.0
SECONDS_SMALL = 150.0  # second size for the marginal (slope) rate
REPS = 5
SR = 44100

# Dense bf16 tensor-core peak per device kind, for the MFU estimate.
# Source: NVIDIA H100 data sheet, SXM part, without sparsity, at 700 W.
PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_bf16(kind: str) -> float:
    """Peak bf16 FLOP/s of `kind`; an unknown device is an error."""
    if kind not in PEAK_BF16:
        raise ValueError(
            f"no bf16 peak for device kind {kind!r}; add it to PEAK_BF16 "
            f"with its data-sheet source"
        )
    return PEAK_BF16[kind]


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(line.strip() for line in res.stdout.splitlines() if line.strip())


def require_gpu() -> bool:
    """True on a GPU backend; otherwise says why on stderr. Also turns on
    the persistent compile cache (core/platform.py)."""
    import jax

    from spleeterrt_tpu.core import platform

    if jax.default_backend() != "gpu":
        print(f"error: this benchmark measures a GPU; JAX backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return False
    platform.enable_compile_cache()
    return True


def device_info() -> dict:
    """The device block every benchmark result carries."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": nvidia_smi(),
    }


def median_seconds(fn, *args, reps: int = REPS) -> float:
    """Median wall time of `fn(*args)` to `block_until_ready`, after one
    compile-and-warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _unet_flops_per_tile(cfg) -> float:
    """Analytical conv MACs*2 of one U-Net forward over one (T, F) tile."""
    from spleeterrt_tpu.core import model

    t, f = cfg.time_step, cfg.bin_limit
    total = 0.0
    th, fh = t, f
    for cin, cout in model.ENCODER_CHANNELS:
        th, fh = th // 2, fh // 2
        total += 2.0 * th * fh * cout * 25 * cin
    th, fh = t // 64, f // 64
    for cin, cout in model.DECODER_CHANNELS:
        # transposed conv: every input position drives 25 taps
        total += 2.0 * th * fh * cin * 25 * cout
        th, fh = th * 2, fh * 2
    total += 2.0 * t * f * 2 * 16  # final 4x4 dilated conv, 1->2 ch
    return total


def _pipeline_flops(seconds: float, cfg, n_stems: int) -> float:
    """Useful FLOPs of one 4-stem dispatch: U-Net convs + FFT cost
    (2.5 N log2 N per real transform)."""
    from spleeterrt_tpu.core import separate, transform

    n = int(seconds * SR)
    _, final = transform.offline_pad_sizes(n, cfg.transform)
    tcfg = cfg.transform
    n_out = transform.num_output_frames(final, tcfg)
    nt = separate.num_tiles(n_out, cfg.time_step)
    fft = 2.5 * tcfg.fft_size * math.log2(tcfg.fft_size)
    n_fft = 2 * n_out * (1 + n_stems)  # fwd (2ch) + S stems x 2ch inverse
    return nt * n_stems * _unet_flops_per_tile(cfg) + n_fft * fft


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from spleeterrt_tpu.config import SeparatorConfig
    from spleeterrt_tpu.core import model, separate, transform

    if not require_gpu():
        return 2
    peak = peak_bf16(jax.devices()[0].device_kind)

    cfg = SeparatorConfig(
        bin_limit=1536,  # VST 4-stem config (PluginProcessor.cpp:124)
        time_step=256,
        num_stems=4,
        compute_dtype=jnp.bfloat16,
    )
    params4 = [model.init_params(jax.random.PRNGKey(i)) for i in range(4)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *params4)

    def timed(seconds: float) -> float:
        n = int(seconds * SR)
        rng = np.random.default_rng(0)
        audio = jnp.asarray(rng.standard_normal((2, n)) * 0.3, jnp.float32)
        padded = jax.device_put(transform.pad_offline(audio, cfg.transform))
        return median_seconds(separate.separate_4stem, stacked, padded, cfg)

    t_small = timed(SECONDS_SMALL)
    t_big = timed(SECONDS)
    rtf = SECONDS / t_big
    marginal = (SECONDS - SECONDS_SMALL) / max(t_big - t_small, 1e-9)
    mfu = _pipeline_flops(SECONDS, cfg, 4) / t_big / peak

    print(
        json.dumps(
            {
                "metric": "realtime_factor_4stem_44k1",
                "value": rtf,
                "unit": "x_realtime_per_chip",
                "vs_baseline": rtf / BASELINE_RTF,
                "marginal_rtf": marginal,
                "mfu_pct": 100.0 * mfu,
                "device": device_info(),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
