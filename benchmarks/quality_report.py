"""Quality report: the GPU's stems against fp32 on the CPU, end to end.

The oracle tests pin the plain formulation to the C semantics on small
shapes; this script records the end-to-end numbers at the production widths
(bin limit 1536, time step 256) on a deterministic 12 s synthetic track, for
the 4-stem and the 3-stem graphs (docs/PARITY.md).

Variants, each in its own subprocess so that one process at a time holds
the card and the parent never imports JAX:

- cpu_fp32:         the CPU backend, float32 -- the reference.
- gpu_fp32_highest: the GPU, float32, matmul precision "highest".
- gpu_fp32:         the GPU, float32 at default precision (convs may run
                    in TF32).
- gpu_bf16:         the GPU, bfloat16 compute -- the production default.

Reported: per-stem SNR / SI-SDR / MSE of each GPU variant against cpu_fp32.

Usage: python benchmarks/quality_report.py            (orchestrates)
       python benchmarks/quality_report.py --stage compute ...  (internal)
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

SR = 44100
SECONDS = 12.0


def synth_track(n: int) -> np.ndarray:
    """Deterministic tone-stack + noise stereo mixture."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / SR
    x = np.zeros((2, n), np.float32)
    for freq, amp in ((110.0, 0.2), (440.0, 0.15), (1320.0, 0.1), (3500.0, 0.05)):
        ph = rng.uniform(0, 2 * np.pi, size=2)[:, None]
        x += amp * np.sin(2 * np.pi * freq * t[None, :] + ph).astype(np.float32)
    x += 0.1 * rng.standard_normal((2, n)).astype(np.float32)
    return x


def compute_stage(args):
    import contextlib

    import jax
    import jax.numpy as jnp

    from spleeterrt_tpu.config import SeparatorConfig
    from spleeterrt_tpu.core import model, platform, separate, transform, weights

    platform.enable_compile_cache()
    if jax.default_backend() != args.backend:
        raise SystemExit(
            f"variant wants backend {args.backend!r}, JAX has "
            f"{jax.default_backend()!r}"
        )

    dtype = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32
    cfg = SeparatorConfig(
        bin_limit=1536, time_step=256, num_stems=4, compute_dtype=dtype
    )
    n = int(SECONDS * SR)
    audio = jnp.asarray(synth_track(n))
    padded = transform.pad_offline(audio, cfg.transform)
    preshift, _ = transform.offline_pad_sizes(n, cfg.transform)
    precision = (
        jax.default_matmul_precision("highest")
        if args.precision == "highest"
        else contextlib.nullcontext()
    )

    params4 = weights.stack_params(
        [model.init_params(jax.random.PRNGKey(i)) for i in range(4)]
    )
    p4 = model.init_params(jax.random.PRNGKey(10))
    p2 = model.init_params(jax.random.PRNGKey(11))
    with precision:
        stems4 = separate.separate_nstem(params4, padded, cfg, separate.OUT_BAND_4)
        stems3 = separate.separate_3stem(p4, p2, padded, cfg)
    stems4 = np.asarray(stems4[..., preshift : preshift + n], np.float32)
    stems3 = np.asarray(stems3[..., preshift : preshift + n], np.float32)

    np.savez(args.out, stems4=stems4, stems3=stems3)
    print(f"saved {args.out} backend={jax.default_backend()}", file=sys.stderr)


VARIANTS = {
    "cpu_fp32": ["--backend", "cpu", "--dtype", "fp32"],
    "gpu_fp32_highest": ["--backend", "gpu", "--dtype", "fp32", "--precision", "highest"],
    "gpu_fp32": ["--backend", "gpu", "--dtype", "fp32"],
    "gpu_bf16": ["--backend", "gpu", "--dtype", "bf16"],
}

STEMS4 = ("drums", "bass", "accompaniment", "vocals")
STEMS3 = ("drums", "vocals", "accompaniment")


def compare(a: np.lib.npyio.NpzFile, b, key, names):
    from spleeterrt_tpu.utils import metrics

    out = {}
    for i, name in enumerate(names):
        out[name] = {
            "snr_db": round(metrics.snr_db(b[key][i], a[key][i]), 2),
            "si_sdr_db": round(metrics.si_sdr_db(b[key][i], a[key][i]), 2),
            "mse": float(f"{metrics.mse(b[key][i], a[key][i]):.3e}"),
        }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=["compute"], default=None)
    ap.add_argument("--backend", default="gpu", choices=("cpu", "gpu"))
    ap.add_argument("--dtype", default="fp32")
    ap.add_argument("--precision", default="default", choices=("default", "highest"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--workdir", default=os.path.join(ROOT, ".cache", "quality"))
    args = ap.parse_args()
    if args.stage == "compute":
        compute_stage(args)
        return

    os.makedirs(args.workdir, exist_ok=True)
    files = {}
    for name, flags in VARIANTS.items():
        out = os.path.join(args.workdir, f"{name}.npz")
        files[name] = out
        if os.path.exists(out):
            print(f"# reusing {out}", file=sys.stderr)
            continue
        env = dict(os.environ)
        if flags[1] == "cpu":
            env["JAX_PLATFORMS"] = "cpu"
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--stage", "compute",
             *flags, "--out", out],
            check=True, env=env,
        )

    loaded = {k: np.load(v) for k, v in files.items()}
    truth = loaded["cpu_fp32"]
    report = {"config": "bin_limit=1536 time_step=256, 12 s synthetic track"}
    for name in ("gpu_fp32_highest", "gpu_fp32", "gpu_bf16"):
        report[f"{name}_vs_cpu_fp32_4stem"] = compare(
            truth, loaded[name], "stems4", STEMS4
        )
        report[f"{name}_vs_cpu_fp32_3stem"] = compare(
            truth, loaded[name], "stems3", STEMS3
        )
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
