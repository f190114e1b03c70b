"""Train-and-deploy demonstration: the full loop, with a committed log.

Proves the training subsystem closes end to end (the reference ships fixed
weights only and cannot train at all):

1. synthesize a tone-vs-noise corpus (train + holdout tracks),
2. evaluate holdout SI-SDR with the INITIAL weights through the REAL
   separation pipeline (core/train.evaluate_si_sdr),
3. train the 2 stem nets with the sharded train step,
4. re-evaluate: SI-SDR must improve,
5. export the stems to the reference's raw .dat blob format
   (core/weights.save_coeff_file), reload the blobs, and verify the
   reloaded nets separate a holdout mixture identically to the in-memory
   trained nets (deploy equivalence).

Run: python examples/train_and_deploy.py [--steps 120] [--out DIR]
It prints its JSON log and writes it to DIR/train_and_deploy_log.json.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from spleeterrt_tpu.config import SeparatorConfig
from spleeterrt_tpu.core import model, train, transform, weights
from spleeterrt_tpu.parallel.mesh import make_mesh

SR = 44100


class _ToneNoiseTrack:
    """Duck-typed dataset track: deterministic tone + noise stems."""

    def __init__(self, seed: int, n: int):
        self.n_frames = n
        rng = np.random.default_rng(seed)
        t = np.arange(n) / SR
        freq = rng.uniform(300, 1500)
        tone = (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        noise = (0.1 * rng.standard_normal(n)).astype(np.float32)
        self._stems = np.stack(
            [np.stack([tone, tone]), np.stack([noise, noise])]
        )  # (2 stems, 2 ch, n)

    def read_crop(self, start: int, n: int):
        stems = self._stems[..., start : start + n]
        return stems.sum(axis=0), stems


class _ToneNoiseDataset:
    stem_names = ("tone", "noise")
    sample_rate = SR

    def __init__(self, seeds, n):
        self.tracks = [_ToneNoiseTrack(s, n) for s in seeds]


def make_batch(rng, cfg, batch):
    n = cfg.time_step * cfg.transform.hop + cfg.transform.fft_size
    t = np.arange(n) / SR
    freqs = rng.uniform(300, 1500, size=batch)
    tone = 0.4 * np.sin(2 * np.pi * freqs[:, None] * t)[:, None, :]
    noise = 0.1 * rng.standard_normal((batch, 1, n))
    tone = np.repeat(tone, 2, axis=1).astype(np.float32)
    noise = np.repeat(noise, 2, axis=1).astype(np.float32)
    mix = tone + noise

    def mags(x):
        spec = transform.stft(jnp.asarray(x), cfg.transform, n)
        m = jnp.abs(spec[..., : cfg.bin_limit])[:, :, : cfg.time_step]
        m = m / cfg.transform.fft_size
        return m.transpose(0, 2, 3, 1)

    return mags(mix), jnp.stack([mags(tone), mags(noise)])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out_dir = args.out or tempfile.mkdtemp(prefix="spleeterrt_deploy_")
    os.makedirs(out_dir, exist_ok=True)

    # fp32 throughout: the toy corpus's loss magnitudes (~6e-4) sit at
    # bf16's rounding scale, so bf16 training converges on CPU but can
    # stall on an accelerator's different accumulation order. Production training
    # (examples/train.py) keeps the bf16 default on real-scale data.
    cfg = SeparatorConfig(
        bin_limit=512, time_step=64, num_stems=2, compute_dtype=jnp.float32
    )
    rng = np.random.default_rng(0)
    holdout = _ToneNoiseDataset(seeds=(101, 102), n=8 * SR)
    log = {"steps": args.steps, "batch": args.batch}

    stacked = weights.stack_params(
        [model.init_params(jax.random.PRNGKey(i)) for i in range(2)]
    )
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(3e-4))
    state = train.init_train_state(stacked, opt)

    before = train.evaluate_si_sdr(state.params, holdout, cfg, seconds=6.0)
    log["si_sdr_init"] = {k: round(v, 3) for k, v in before.items()}

    n_dev = len(jax.devices())
    mesh = make_mesh(stem_parallel=2 if n_dev % 2 == 0 else 1)
    state = train.shard_train_state(state, mesh, n_stems=2)
    step = train.make_sharded_train_step(mesh, opt, compute_dtype=jnp.float32)
    t0 = time.perf_counter()
    losses = []
    for i in range(args.steps):
        mix, targets = make_batch(rng, cfg, args.batch)
        state, loss = step(state, mix, targets)
        if i % 20 == 0 or i == args.steps - 1:
            losses.append(round(float(loss), 5))
    log["loss_curve"] = losses
    log["train_seconds"] = round(time.perf_counter() - t0, 1)

    after = train.evaluate_si_sdr(state.params, holdout, cfg, seconds=6.0)
    log["si_sdr_trained"] = {k: round(v, 3) for k, v in after.items()}
    log["si_sdr_gain_db"] = round(after["mean"] - before["mean"], 3)
    assert after["mean"] > before["mean"], "training did not improve SI-SDR"

    # --- deploy: export .dat blobs, reload, verify identical separation ---
    deployed = train.deploy_params(state.params, cfg.transform.fft_size)
    blob_paths = []
    for s, name in enumerate(holdout.stem_names):
        p_s = jax.tree.map(lambda a: np.asarray(a[s]), deployed)
        path = os.path.join(out_dir, f"{name}.dat")
        weights.save_coeff_file(p_s, path)
        blob_paths.append(path)
    log["blobs"] = [os.path.basename(p) for p in blob_paths]
    log["blob_bytes"] = os.path.getsize(blob_paths[0])

    reloaded = weights.stack_params(
        [weights.blob_to_params(open(p, "rb").read()) for p in blob_paths]
    )
    from spleeterrt_tpu.core import separate as sep

    mix, stems = holdout.tracks[0].read_crop(0, 4 * SR)
    padded = transform.pad_offline(jnp.asarray(mix), cfg.transform)
    est_mem = np.asarray(sep.separate_nstem(deployed, padded, cfg, (0.0, 0.0)))
    est_blob = np.asarray(sep.separate_nstem(reloaded, padded, cfg, (0.0, 0.0)))
    roundtrip_err = float(np.max(np.abs(est_mem - est_blob)))
    log["deploy_roundtrip_max_err"] = roundtrip_err
    assert roundtrip_err < 1e-5, "blob round trip changed the separation"

    from spleeterrt_tpu.utils import metrics

    preshift, _ = transform.offline_pad_sizes(mix.shape[-1], cfg.transform)
    est = est_blob[..., preshift : preshift + mix.shape[-1]]
    log["deployed_si_sdr_db"] = {
        name: round(metrics.si_sdr_db(est[i], stems[i]), 3)
        for i, name in enumerate(holdout.stem_names)
    }

    print(json.dumps(log, indent=1))
    with open(os.path.join(out_dir, "train_and_deploy_log.json"), "w") as f:
        json.dump(log, f, indent=1)


if __name__ == "__main__":
    main()
