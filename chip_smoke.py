"""Smoke test of the separation system on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one GPU:

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --four-cards  # only the multi-card paths, 4 GPUs

Everything runs in this one process. The one-card phases, in order:

1. device   -- the JAX backend is "gpu"; prints the device kind and count
               and `nvidia-smi`'s name and power limit.
2. cli      -- `spleeterrt_tpu.cli.main` on a seeded 60 s stereo WAV,
               4 stems at the VST widths (time step 256, bin limit 1536),
               random weights; checks the banner, the stems' shape and
               finiteness, the masked-energy bound and equality with a
               direct `separate.separate` call.
3. parity   -- the 4-stem graph on 12 s of audio on the GPU in fp32 at
               "highest" matmul precision, in bf16 (production) and in fp32
               at default precision, each against fp32 on the CPU backend
               of the same process (bounds: docs/NUMERICS.md section 7).
4. conserve -- 2-stem conservation, max|vocals + accompaniment - input|.
5. server   -- `runtime.server` on 127.0.0.1: three POST /separate and one
               /separate_batch of 4 tracks, against direct calls.
6. streams  -- `runtime.stream.block_step_streams`, K=8 streams, 4 blocks,
               against the same steps in fp32 on the CPU backend.
7. train    -- 5 optax steps of `core.train` at T=512, F=1024, batch 4,
               2 stems: the loss stays finite and falls.

`--four-cards` runs the multi-card paths instead, each against the same
input on one card: the server's batch endpoint, `separate_batch_sharded`
on 8 tracks, the stem-sharded 4-stem graph and the time-sharded 4-stem
graph on a 10-minute track.

The script stops at the first failing phase with exit code 1. It exits
with code 2, and prints no result, when JAX finds no GPU or when the
package is not next to it. On success its last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import http.client
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 44100

# dB bounds against the fp32 CPU reference (docs/NUMERICS.md section 7).
SNR_FP32_HIGHEST_DB = 100.0
SNR_BF16_DB = 38.0
CONSERVATION_ATOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of every phase; the defaults are the production widths."""

    bin_limit: int = 1536
    time_step: int = 256
    cli_seconds: float = 60.0
    parity_seconds: float = 12.0
    server_seconds: float = 10.0
    stream_k: int = 8
    stream_blocks: int = 4
    train_t: int = 512
    train_f: int = 1024
    train_batch: int = 4
    train_steps: int = 5
    batch_tracks: int = 8
    long_seconds: float = 600.0


class PhaseError(RuntimeError):
    """A phase's check failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def music(seed: int, seconds: float) -> np.ndarray:
    """Seeded stereo test signal: a few partials, a beat and some noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    x = np.zeros(n)
    for f0 in rng.uniform(80.0, 1200.0, 6):
        x += rng.uniform(0.02, 0.1) * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6.3))
    x += 0.2 * np.exp(-30.0 * (t % 0.5)) * rng.standard_normal(n)
    x += 0.02 * rng.standard_normal(n)
    return np.stack([x, np.roll(0.8 * x, 37)]).astype(np.float32)


def snr_db(got, ref) -> float:
    from spleeterrt_tpu.utils import metrics

    return metrics.snr_db(got, ref)


def random_weights(cfg, seed: int = 0) -> dict:
    """The CLI's --random-weights params for `cfg`'s stem count."""
    from spleeterrt_tpu import cli

    args = argparse.Namespace(random_weights=True, weights=None, seed=seed)
    return cli._load_weights(args, cfg)


def _cfg(sizes: Sizes, num_stems: int, dtype):
    from spleeterrt_tpu.config import SeparatorConfig

    return SeparatorConfig(
        bin_limit=sizes.bin_limit,
        time_step=sizes.time_step,
        num_stems=num_stems,
        compute_dtype=dtype,
    )


# --------------------------------------------------------------------------
# Phases. Each takes the sizes and the devices it compares, checks, and
# returns the values it compared.
# --------------------------------------------------------------------------


def phase_cli(sizes: Sizes, platform: str) -> dict:
    import jax.numpy as jnp

    from spleeterrt_tpu import cli
    from spleeterrt_tpu.core import separate
    from spleeterrt_tpu.io import audio as audio_io

    x = music(1, sizes.cli_seconds)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "mix.wav")
        audio_io.write_wav(wav, x, SR)
        out_dir = os.path.join(tmp, "stems")
        argv = [
            wav, "--stems", "4", "--time-step", str(sizes.time_step),
            "--bin-limit", str(sizes.bin_limit), "--random-weights",
            "--output-dir", out_dir,
        ]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        for line in buf.getvalue().splitlines():
            log(f"    | {line}")
        check(rc == 0, f"cli exit code {rc}")
        check(f"{platform} backend" in buf.getvalue(), f"no '{platform} backend' banner")
        cfg = _cfg(sizes, 4, jnp.bfloat16)
        stems = {
            name: audio_io.read_wav(
                os.path.join(out_dir, f"mix_{cli.STEM_FILENAMES[name]}.wav")
            ).samples
            for name in cfg.stem_names
        }
    direct = separate.separate(x, cfg=cfg, **random_weights(cfg))
    e_in = float(np.sum(x.astype(np.float64) ** 2))
    out = {"stems": len(stems)}
    for name, y in stems.items():
        check(y.shape == x.shape, f"{name}: shape {y.shape} != {x.shape}")
        check(bool(np.all(np.isfinite(y))), f"{name}: non-finite samples")
        # Masks in [0, 1] and out-of-band weights <= 0.25 bound each stem's
        # energy by the input's (docs/NUMERICS.md section 7).
        ratio = float(np.sum(y.astype(np.float64) ** 2)) / e_in
        check(ratio <= 1.0 + 1e-3, f"{name}: energy ratio {ratio} > 1")
        diff = float(np.max(np.abs(y - np.asarray(direct[name]))))
        check(diff <= 1e-6, f"{name}: cli vs direct separate differ by {diff}")
        out[f"{name}_energy_ratio"] = ratio
        out[f"{name}_cli_vs_direct_max_abs"] = diff
    total = sum(stems.values())
    out["stem_sum_vs_input_snr_db"] = snr_db(total, x)
    return out


def phase_parity(sizes: Sizes, acc, cpu) -> dict:
    import jax
    import jax.numpy as jnp

    from spleeterrt_tpu.core import separate, transform

    cfg32 = _cfg(sizes, 4, jnp.float32)
    cfg16 = _cfg(sizes, 4, jnp.bfloat16)
    params = random_weights(cfg32)["stacked_params"]
    x = music(2, sizes.parity_seconds)
    n = x.shape[-1]
    padded = transform.pad_offline(jnp.asarray(x), cfg32.transform)
    pre = cfg32.transform.fft_size

    def run(cfg, device):
        p = jax.device_put(params, device)
        a = jax.device_put(padded, device)
        return np.asarray(separate.separate_4stem(p, a, cfg))[..., pre : pre + n]

    ref = run(cfg32, cpu)
    with jax.default_matmul_precision("highest"):
        highest = run(cfg32, acc)
    bf16 = run(cfg16, acc)
    default = run(cfg32, acc)
    out = {}
    for label, got, bound in (
        ("fp32_highest", highest, SNR_FP32_HIGHEST_DB),
        ("bf16", bf16, SNR_BF16_DB),
        ("fp32_default", default, None),
    ):
        snrs = [snr_db(got[s], ref[s]) for s in range(4)]
        out[f"{label}_min_snr_db"] = min(snrs)
        out[f"{label}_snr_db"] = [round(v, 2) for v in snrs]
        check(bool(np.all(np.isfinite(got))), f"{label}: non-finite stems")
        if bound is not None:
            check(min(snrs) >= bound, f"{label}: SNR {min(snrs):.2f} dB < {bound} dB")
    return out


def phase_conserve(sizes: Sizes) -> dict:
    import jax
    import jax.numpy as jnp

    from spleeterrt_tpu.core import model, separate

    cfg = _cfg(sizes, 2, jnp.bfloat16)
    params = model.init_params(jax.random.PRNGKey(3))
    x = music(3, sizes.parity_seconds)
    got = separate.separate(x, params=params, cfg=cfg)
    resid = float(
        np.max(np.abs(np.asarray(got["vocals"]) + np.asarray(got["accompaniment"]) - x))
    )
    check(resid <= CONSERVATION_ATOL, f"2-stem residual {resid} > {CONSERVATION_ATOL}")
    return {"max_abs_residual": resid}


def _post(port: int, path: str, body: bytes) -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200, f"POST {path}: HTTP {resp.status} {data[:200]!r}")
        return data
    finally:
        conn.close()


def _wav_bytes(x: np.ndarray) -> bytes:
    from spleeterrt_tpu.io import audio as audio_io

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.wav")
        audio_io.write_wav(path, x, SR)
        with open(path, "rb") as f:
            return f.read()


def phase_server(sizes: Sizes) -> dict:
    import jax.numpy as jnp

    from spleeterrt_tpu.core import separate
    from spleeterrt_tpu.runtime import server

    cfg = _cfg(sizes, 4, jnp.bfloat16)
    weights = random_weights(cfg)
    service = server.SeparationService(cfg, weights)
    srv = server.make_server("127.0.0.1", 0, service)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    out = {}
    try:
        for i in range(3):
            x = music(10 + i, sizes.server_seconds)
            body = _post(port, "/separate?format=npz", _wav_bytes(x))
            with np.load(io.BytesIO(body)) as z:
                got = {k: z[k] for k in z.files}
            ref = separate.separate(x, cfg=cfg, **weights)
            check(set(got) == set(cfg.stem_names), f"stems {sorted(got)}")
            diff = max(float(np.max(np.abs(got[k] - np.asarray(ref[k])))) for k in got)
            check(diff <= 1e-6, f"/separate #{i}: differs from direct call by {diff}")
            out[f"separate_{i}_max_abs"] = diff

        tracks = {f"t{i}": music(20 + i, sizes.server_seconds) for i in range(4)}
        buf = io.BytesIO()
        np.savez(buf, **tracks)
        body = _post(port, "/separate_batch", buf.getvalue())
        with np.load(io.BytesIO(body)) as z:
            got = {k: z[k] for k in z.files}
        snrs = []
        for name, x in tracks.items():
            ref = separate.separate(x, cfg=cfg, **weights)
            for stem in cfg.stem_names:
                snrs.append(snr_db(got[f"{name}/{stem}"], ref[stem]))
        # One batched dispatch may pick other conv algorithms than four
        # single-track ones: the bound is the bf16 one.
        out["batch_min_snr_db"] = min(snrs)
        check(min(snrs) >= SNR_BF16_DB, f"/separate_batch SNR {min(snrs):.2f} dB")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread did not stop")
    return out


def phase_streams(sizes: Sizes, acc, cpu) -> dict:
    import jax
    import jax.numpy as jnp

    from spleeterrt_tpu.runtime import stream

    cfg16 = _cfg(sizes, 4, jnp.bfloat16)
    cfg32 = _cfg(sizes, 4, jnp.float32)
    params = random_weights(cfg32)["stacked_params"]
    k = sizes.stream_k
    rng = np.random.default_rng(4)
    block_len = sizes.time_step * stream.HOP
    blocks = [
        (0.3 * rng.standard_normal((k, 2, block_len))).astype(np.float32)
        for _ in range(sizes.stream_blocks)
    ]

    def run(cfg, device):
        p = jax.device_put(params, device)
        state = jax.device_put(stream.init_state_streams(cfg, 4, k), device)
        outs = []
        for b in blocks:
            state, y = stream.block_step_streams(
                p, state, jax.device_put(b, device), cfg, 4
            )
            outs.append(np.asarray(y))
        return np.stack(outs, axis=-2)  # (K, S, 2, blocks, T*HOP)

    got = run(cfg16, acc)
    ref = run(cfg32, cpu)
    check(bool(np.all(np.isfinite(got))), "non-finite stream output")
    snrs = [snr_db(got[i, s], ref[i, s]) for i in range(k) for s in range(4)]
    check(min(snrs) >= SNR_BF16_DB, f"stream SNR {min(snrs):.2f} dB < {SNR_BF16_DB}")
    return {"streams": k, "blocks": len(blocks), "min_snr_db": min(snrs)}


def phase_train(sizes: Sizes) -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from spleeterrt_tpu.config import STEM_MODE_2
    from spleeterrt_tpu.core import model, train, weights

    stacked = weights.stack_params(
        [model.init_params(jax.random.PRNGKey(i)) for i in range(2)]
    )
    key = jax.random.PRNGKey(5)
    mix = jnp.abs(
        jax.random.normal(key, (sizes.train_batch, sizes.train_t, sizes.train_f, 2))
    )
    # A learnable target: fixed per-stem fractions of the mixture.
    targets = jnp.stack([0.7 * mix, 0.3 * mix])
    opt = optax.adam(1e-3)
    state = train.init_train_state(stacked, opt)
    step = jax.jit(train.make_train_step(opt, stem_mode=STEM_MODE_2))
    losses = []
    for _ in range(sizes.train_steps):
        state, loss = step(state, mix, targets)
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return {"losses": [round(v, 6) for v in losses]}


def phase_four_cards(sizes: Sizes, devices) -> dict:
    """Multi-card paths on `devices`, each against one card (devices[0])."""
    import jax
    import jax.numpy as jnp

    from spleeterrt_tpu.core import separate, transform
    from spleeterrt_tpu.parallel import mesh as pmesh
    from spleeterrt_tpu.parallel import timeshard
    from spleeterrt_tpu.runtime import server

    cfg = _cfg(sizes, 4, jnp.bfloat16)
    weights = random_weights(cfg)
    stacked = weights["stacked_params"]
    one = pmesh.make_mesh(devices[:1])
    out = {}

    def compare(label, got, ref):
        got, ref = np.asarray(got), np.asarray(ref)
        check(got.shape == ref.shape, f"{label}: shape {got.shape} != {ref.shape}")
        check(bool(np.all(np.isfinite(got))), f"{label}: non-finite output")
        snr = snr_db(got, ref)
        out[f"{label}_snr_db"] = snr
        out[f"{label}_max_abs"] = float(np.max(np.abs(got - ref)))
        check(snr >= SNR_BF16_DB, f"{label}: SNR {snr:.2f} dB < {SNR_BF16_DB}")

    # The server's batch path meshes over every device of the process.
    tracks = {f"t{i}": music(30 + i, sizes.server_seconds) for i in range(4)}
    buf = io.BytesIO()
    np.savez(buf, **tracks)
    service = server.SeparationService(cfg, weights)
    got = service.separate_batch(buf.getvalue())
    batch = np.stack(list(tracks.values()))
    padded = transform.pad_offline(jnp.asarray(batch), cfg.transform)
    pre = cfg.transform.fft_size
    n = batch.shape[-1]
    ref = np.asarray(pmesh.separate_batch_sharded(stacked, padded, cfg, one))
    compare(
        "server_batch",
        np.stack([[got[f"{t}/{s}"] for s in cfg.stem_names] for t in tracks]),
        ref[..., pre : pre + n],
    )

    x8 = np.stack([music(40 + i, sizes.server_seconds) for i in range(sizes.batch_tracks)])
    padded8 = transform.pad_offline(jnp.asarray(x8), cfg.transform)
    mesh = pmesh.make_mesh(devices)
    compare(
        "batch_sharded",
        pmesh.separate_batch_sharded(stacked, padded8, cfg, mesh),
        pmesh.separate_batch_sharded(stacked, padded8, cfg, one),
    )

    x = music(50, sizes.parity_seconds)
    padded1 = transform.pad_offline(jnp.asarray(x), cfg.transform)
    stem_mesh = pmesh.make_mesh(devices, stem_parallel=4)
    compare(
        "stem_sharded",
        pmesh.separate_4stem_sharded(
            pmesh.shard_params(stacked, stem_mesh, stem_sharded=True),
            padded1, cfg, stem_mesh,
        ),
        separate.separate_4stem(
            jax.device_put(stacked, devices[0]), jax.device_put(padded1, devices[0]), cfg
        ),
    )

    long = music(60, sizes.long_seconds)
    got = timeshard.separate_4stem_timesharded_padded(stacked, jnp.asarray(long), cfg, mesh)
    with jax.default_device(devices[0]):
        ref = separate.separate(long, stacked_params=stacked, cfg=cfg)
    compare("timesharded", got, np.stack([np.asarray(ref[s]) for s in cfg.stem_names]))
    return out


# --------------------------------------------------------------------------


def nvidia_smi() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` lines."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in res.stdout.splitlines() if line.strip()]


def result_line(devices) -> str:
    """The final line: {"ok": true, "device": {platform, kind, count}}."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--four-cards", action="store_true",
        help="run only the multi-card paths (needs 4 GPUs)",
    )
    return p


def run_phases(phases) -> bool:
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            values = fn()
        except PhaseError as e:
            print(f"FAIL {name}: {e}", file=sys.stderr, flush=True)
            return False
        dt = time.perf_counter() - t0
        log(f"phase {name}: ok in {dt:.1f} s {json.dumps(values)}")
    return True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "spleeterrt_tpu")):
        print("error: run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # The CPU backend is the reference: keep it beside the GPU.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    from spleeterrt_tpu.core import platform

    if jax.default_backend() != "gpu":
        print(f"error: no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    platform.enable_compile_cache()
    devices = jax.devices()
    cpu = jax.devices("cpu")[0]
    log(f"device: {devices[0].device_kind} x {len(devices)} ({devices[0].platform})")
    for line in nvidia_smi():
        log(f"nvidia-smi: {line}")
    sizes = Sizes()
    if args.four_cards:
        if len(devices) != 4:
            print(f"error: --four-cards needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 1
        phases = [("four_cards", lambda: phase_four_cards(sizes, devices))]
    else:
        acc = devices[0]
        phases = [
            ("cli", lambda: phase_cli(sizes, "gpu")),
            ("parity", lambda: phase_parity(sizes, acc, cpu)),
            ("conserve", lambda: phase_conserve(sizes)),
            ("server", lambda: phase_server(sizes)),
            ("streams", lambda: phase_streams(sizes, acc, cpu)),
            ("train", lambda: phase_train(sizes)),
        ]
    if not run_phases(phases):
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
