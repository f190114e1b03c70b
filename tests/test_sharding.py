"""Mesh/collective logic on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from spleeterrt_tpu.config import SeparatorConfig
from spleeterrt_tpu.core import model, separate, train, transform, weights
from spleeterrt_tpu.parallel import mesh as pmesh

CFG = SeparatorConfig(
    bin_limit=512, time_step=64, num_stems=4, compute_dtype=jnp.float32
)


def _stacked(rng):
    return weights.stack_params(
        [weights.blob_to_params(weights.random_blob(rng, 0.02)) for _ in range(4)]
    )


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_masks_match_single_device(rng):
    stacked = _stacked(rng)
    audio = jnp.asarray(rng.standard_normal((2, 3 * 4096)), jnp.float32) * 0.3
    padded = transform.pad_offline(audio, CFG.transform)
    spec = transform.stft(padded, CFG.transform, padded.shape[-1])

    ref = separate.compute_masks_multi(stacked, spec, CFG, 1)

    m = pmesh.make_mesh(stem_parallel=4)  # 4 stem groups x 2 data
    sharded_params = pmesh.shard_params(stacked, m, stem_sharded=True)
    got = jax.jit(
        lambda p, s: pmesh.compute_masks_sharded(p, s, CFG, m)
    )(sharded_params, spec)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-5)


def test_sharded_separation_matches_single_device(rng):
    stacked = _stacked(rng)
    audio = jnp.asarray(rng.standard_normal((2, 2 * 4096)), jnp.float32) * 0.3
    padded = transform.pad_offline(audio, CFG.transform)

    ref = separate.separate_4stem(stacked, padded, CFG)

    m = pmesh.make_mesh(stem_parallel=2)  # 2 x 4
    sharded_params = pmesh.shard_params(stacked, m, stem_sharded=True)
    got = pmesh.separate_4stem_sharded(sharded_params, padded, CFG, m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4)


def test_sharded_train_step_runs_and_matches(rng):
    stacked = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[model.init_params(jax.random.PRNGKey(i)) for i in range(4)],
    )
    optimizer = optax.adam(1e-3)
    key = jax.random.PRNGKey(1)
    mix = jnp.abs(jax.random.normal(key, (4, 64, 512, 2)))
    targets = jnp.abs(jax.random.normal(key, (4, 4, 64, 512, 2)))

    # Single-device reference (fp32 compute for determinism).
    ref_state = train.init_train_state(stacked, optimizer)
    ref_step = train.make_train_step(optimizer, compute_dtype=jnp.float32)
    ref_state, ref_loss = jax.jit(ref_step)(ref_state, mix, targets)

    m = pmesh.make_mesh(stem_parallel=4)
    state = train.init_train_state(stacked, optimizer)
    state = train.shard_train_state(state, m, n_stems=4)
    step = train.make_sharded_train_step(m, optimizer, compute_dtype=jnp.float32)
    state, loss = step(state, mix, targets)

    assert int(state.step) == 1
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(state.params["down1"]["w"]),
        np.asarray(ref_state.params["down1"]["w"]),
        atol=1e-6,
    )


def test_graft_dryrun():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (4, 2, 64, 512, 2)
    __graft_entry__.dryrun_multichip(8)


def test_timesharded_separation_matches_replicated(rng):
    """Sequence-parallel (sample-axis sharded) pipeline == replicated."""
    from spleeterrt_tpu.parallel import timeshard

    stacked = _stacked(rng)
    n = 150000  # not a tidy multiple of anything
    audio = jnp.asarray(rng.standard_normal((2, n)), jnp.float32) * 0.3

    ref = separate.separate(np.asarray(audio), stacked_params=stacked, cfg=CFG)

    m = pmesh.make_mesh(stem_parallel=1)  # pure 8-way sequence parallelism
    got = timeshard.separate_4stem_timesharded_padded(stacked, audio, CFG, m)
    got = np.asarray(got)
    for i, stem in enumerate(CFG.stem_names):
        np.testing.assert_allclose(
            got[i], np.asarray(ref[stem]), atol=5e-5,
            err_msg=f"stem {stem} mismatch",
        )


def test_batched_multitrack_sharded(rng):
    """Tracks sharded over the mesh match per-track separation."""
    stacked = _stacked(rng)
    n = 2 * 4096
    tracks = jnp.asarray(rng.standard_normal((8, 2, n)), jnp.float32) * 0.3
    padded = jax.vmap(lambda a: transform.pad_offline(a, CFG.transform))(tracks)

    m = pmesh.make_mesh(stem_parallel=1)
    got = pmesh.separate_batch_sharded(stacked, padded, CFG, m)
    ref0 = separate.separate_4stem(stacked, padded[3], CFG)
    np.testing.assert_allclose(
        np.asarray(got[3]), np.asarray(ref0), atol=2e-5
    )


def test_stream_scan_sharded_matches_unsharded(rng):
    """Stem-sharded streaming == single-device streaming, sample-exact."""
    from spleeterrt_tpu.runtime import stream

    cfg = SeparatorConfig(
        bin_limit=512, time_step=64, num_stems=4, compute_dtype=jnp.float32
    )
    stacked = _stacked(rng)
    n = 3 * cfg.time_step * 1024
    audio = jnp.asarray(rng.standard_normal((2, n)), jnp.float32) * 0.3

    ref = np.asarray(stream.stream_scan(stacked, audio, cfg, 4))
    m = pmesh.make_mesh(stem_parallel=4)
    got = np.asarray(pmesh.stream_scan_sharded(stacked, audio, cfg, m, 4))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_sharded_2stem_matches_unsharded(rng):
    params = weights.blob_to_params(weights.random_blob(rng, 0.02))
    audio = jnp.asarray(rng.standard_normal((2, 2 * 4096)), jnp.float32) * 0.3
    padded = transform.pad_offline(audio, CFG.transform)
    ref = separate.separate_2stem(params, padded, CFG)
    m = pmesh.make_mesh(stem_parallel=1)
    got = pmesh.separate_2stem_sharded(params, padded, CFG, m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4)


def test_sharded_2stem_batch_matches_per_track(rng):
    """Batched 2-stem offline graph (single net, uw 0.1 + time-domain
    residual, Executable/main.c:773,794-798) sharded over the mesh matches
    the per-track graph; and make_batch_fn rejects a 2-net stack loudly."""
    import pytest

    params = weights.blob_to_params(weights.random_blob(rng, 0.02))
    tracks = jnp.asarray(
        rng.standard_normal((4, 2, 2 * 4096)), jnp.float32
    ) * 0.3
    padded = jax.vmap(lambda a: transform.pad_offline(a, CFG.transform))(tracks)

    m = pmesh.make_mesh(stem_parallel=1)
    got = pmesh.separate_2stem_batch_sharded(params, padded, CFG, m)
    ref2 = separate.separate_2stem(params, padded[2], CFG)
    assert got.shape[:2] == (4, 2)
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(ref2), atol=2e-5)
    # 2-stem conservation survives the batch: stems sum to the track.
    ds = padded.shape[-1]
    np.testing.assert_allclose(
        np.asarray(got[1, 0] + got[1, 1])[:, :ds], np.asarray(padded[1]),
        atol=1e-5,
    )

    stacked2 = weights.stack_params([params, params])
    with pytest.raises(ValueError, match="2-stem"):
        pmesh.separate_batch_sharded(stacked2, padded, CFG, m)


def test_sharded_3stem_matches_unsharded(rng):
    params4 = weights.blob_to_params(weights.random_blob(rng, 0.02))
    params2 = weights.blob_to_params(weights.random_blob(rng, 0.015))
    audio = jnp.asarray(rng.standard_normal((2, 2 * 4096)), jnp.float32) * 0.3
    padded = transform.pad_offline(audio, CFG.transform)
    ref = separate.separate_3stem(params4, params2, padded, CFG)
    m = pmesh.make_mesh(stem_parallel=2)
    got = pmesh.separate_3stem_sharded(params4, params2, padded, CFG, m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4)


def test_sharded_3stem_batch_matches_per_track(rng):
    """Batched two-pass 3-stem graph sharded over the mesh matches the
    per-track graph (drums/vocals/accompaniment, main.c:845-970)."""
    params4 = weights.blob_to_params(weights.random_blob(rng, 0.02))
    params2 = weights.blob_to_params(weights.random_blob(rng, 0.015))
    tracks = jnp.asarray(
        rng.standard_normal((4, 2, 2 * 4096)), jnp.float32
    ) * 0.3
    padded = jax.vmap(lambda a: transform.pad_offline(a, CFG.transform))(tracks)

    m = pmesh.make_mesh(stem_parallel=1)
    got = pmesh.separate_3stem_batch_sharded(params4, params2, padded, CFG, m)
    ref1 = separate.separate_3stem(params4, params2, padded[1], CFG)
    assert got.shape[:2] == (4, 3)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref1), atol=2e-5)


def test_sharded_stream_steps_match_unsharded(rng):
    """K=8 streams over 8 devices, two chained blocks, sample-exact vs the
    single-device multi-stream step."""
    from spleeterrt_tpu.runtime import stream

    stacked = _stacked(rng)
    k = 8
    block_len = CFG.time_step * stream.HOP
    blocks = [
        jnp.asarray(rng.standard_normal((k, 2, block_len)), jnp.float32) * 0.3
        for _ in range(2)
    ]

    ref_state = stream.init_state_streams(CFG, 4, k)
    refs = []
    for b in blocks:
        ref_state, out = stream.block_step_streams(
            stacked, ref_state, b, CFG, 4
        )
        refs.append(out)

    m = pmesh.make_mesh(stem_parallel=1)
    step, n_dev = pmesh.make_stream_fn(CFG, m, 4)
    assert n_dev == 8
    state = stream.init_state_streams(CFG, 4, k)
    for b, ref in zip(blocks, refs):
        state, out = step(stacked, state, b)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
