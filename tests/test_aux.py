"""Auxiliary subsystems: checkpointing, timing/observability, distributed."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from spleeterrt_tpu.core import checkpoint, model, train, weights
from spleeterrt_tpu.parallel import distributed
from spleeterrt_tpu.utils import timing


def _state():
    stacked = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[model.init_params(jax.random.PRNGKey(i)) for i in range(2)],
    )
    opt = optax.adam(1e-3)
    return train.init_train_state(stacked, opt), opt


def test_loss_grads_finite_at_huge_preactivations():
    """ELU backward stability (round-5 regression): pre-activations past
    exp's f32 overflow point (~88) must not NaN the gradients -- the
    where-zeroed cotangent multiplied d(expm1) = exp(x) = inf into
    0 * inf = NaN before _elu clamped its argument from above. Observed
    killing training at step 88 of examples/train_and_deploy.py."""
    stacked = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[model.init_params(jax.random.PRNGKey(i)) for i in range(2)],
    )
    # Blow up the first conv so its pre-activations far exceed 88.
    stacked["down1"]["w"] = stacked["down1"]["w"] * 1e4
    stacked["down1"]["b"] = stacked["down1"]["b"] + 500.0
    mix = jnp.abs(jax.random.normal(jax.random.PRNGKey(0), (2, 64, 512, 2)))
    tgt = jnp.abs(jax.random.normal(jax.random.PRNGKey(1), (2, 2, 64, 512, 2)))

    loss, grads = jax.jit(
        jax.value_and_grad(train.separation_loss),
        static_argnames=("stem_mode",),
    )(stacked, mix, tgt, stem_mode=1)
    assert np.isfinite(float(loss))
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        assert bool(jnp.all(jnp.isfinite(g))), jax.tree_util.keystr(path)


def test_checkpoint_round_trip(tmp_path):
    state, opt = _state()
    step = train.make_train_step(opt, compute_dtype=jnp.float32)
    mix = jnp.abs(jax.random.normal(jax.random.PRNGKey(0), (2, 64, 512, 2)))
    tgt = jnp.abs(jax.random.normal(jax.random.PRNGKey(1), (2, 2, 64, 512, 2)))
    state, _ = jax.jit(step)(state, mix, tgt)

    path = tmp_path / "ckpt" / "step_1"
    checkpoint.save(path, state)
    template = jax.tree.map(jnp.zeros_like, state)
    restored = checkpoint.restore(path, template)
    assert int(restored.step) == 1
    np.testing.assert_array_equal(
        np.asarray(restored.params["down1"]["w"]),
        np.asarray(state.params["down1"]["w"]),
    )
    assert checkpoint.latest_step_dir(tmp_path / "ckpt").endswith("step_1")


def test_stage_timer(capsys):
    t = timing.StageTimer()
    with t.stage("load"):
        x = jnp.ones((8, 8))
    with t.stage("compute", sync=x * 2):
        pass
    rep = t.report()
    assert set(rep) == {"load", "compute"}
    assert "load takes" in capsys.readouterr().out


def test_png_spectrogram_dump(tmp_path, rng):
    mag = np.abs(rng.standard_normal((2, 64, 128)))
    paths = timing.dump_spectrogram_pngs(mag, str(tmp_path / "spec"))
    assert len(paths) == 2
    for p in paths:
        data = open(p, "rb").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"


def test_distributed_single_process_noop():
    distributed.initialize()  # no-op at 1 process
    mesh = distributed.global_mesh(stem_parallel=2)
    assert mesh.shape == {"stem": 2, "data": 4}
    assert distributed.is_coordinator()


def test_blob_export_after_training(tmp_path):
    """Trained params round-trip into the reference's .dat blob format."""
    state, opt = _state()
    p0 = jax.tree.map(lambda a: a[0], state.params)
    path = tmp_path / "vocal4stems.dat"
    weights.save_coeff_file(p0, path)
    assert path.stat().st_size == weights.COEFF_BLOB_BYTES
    back = weights.load_coeff_file(path)
    np.testing.assert_array_equal(
        np.asarray(back["up3"]["w"]), np.asarray(p0["up3"]["w"])
    )
