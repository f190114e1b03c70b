"""Per-layer parity of the plain U-Net against the index-arithmetic oracle.

Each of the 13 layers (down1-6, up1-6, up7) runs on its own at its real
channel widths, in both stem modes (leaky/ReLU and ELU), against
tests/oracle/reference_oracle.py's layer of the same name.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from spleeterrt_tpu.config import STEM_MODE_2, STEM_MODE_4
from spleeterrt_tpu.core import model, weights
from tests.oracle import reference_oracle as oracle

LAYERS = [f"down{i}" for i in range(1, 7)] + [f"up{i}" for i in range(1, 8)]


def _cin(name: str) -> int:
    i = int(name[-1])
    if name.startswith("down"):
        return model.ENCODER_CHANNELS[i - 1][0]
    if name == "up7":
        return model.FINAL_CHANNELS[0]
    return model.DECODER_CHANNELS[i - 1][0]


@pytest.mark.parametrize("stem_mode", [STEM_MODE_2, STEM_MODE_4])
@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_oracle(name, stem_mode):
    rng = np.random.default_rng(LAYERS.index(name))
    blob = weights.random_blob(rng, scale=0.2)
    params = weights.blob_to_params(blob)
    fields = oracle.unpack_blob(blob)
    i = int(name[-1])
    # Encoders halve 8x8; decoders double 4x4; up7 keeps 8x8.
    hw = (4, 4) if name.startswith("up") and name != "up7" else (8, 8)
    x = rng.standard_normal((_cin(name),) + hw) * 2.0
    x_nhwc = jnp.asarray(x.transpose(1, 2, 0)[None], jnp.float32)

    if name.startswith("down"):
        ref_skip, ref = oracle.encoder_layer(fields, x, i, stem_mode)
        skip, got = model.encoder_layer(
            params[name], x_nhwc, i, stem_mode, jnp.float32
        )
        np.testing.assert_allclose(
            np.asarray(skip)[0].transpose(2, 0, 1), ref_skip, atol=1e-4, rtol=1e-4
        )
    elif name == "up7":
        ref = oracle.mask_layer(fields, x)
        got = model.mask_layer(params[name], x_nhwc, jnp.float32)
    else:
        ref = oracle.decoder_layer(fields, x, i, stem_mode)
        got = model.decoder_layer(params[name], x_nhwc, i, stem_mode, jnp.float32)
    got = np.asarray(got)[0].transpose(2, 0, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
