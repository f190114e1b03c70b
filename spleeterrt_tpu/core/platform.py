"""Which platform the pipeline runs on, and where compiled programs are cached.

Every path in this package is plain JAX: `jnp.fft` (cuFFT on the GPU),
`lax.conv_general_dilated` (cuDNN) and XLA's fusions. The CPU and the GPU
are the supported backends; any other backend is refused here rather than
left to fail somewhere inside a compiled graph.
"""

from __future__ import annotations

import os

import jax

SUPPORTED_BACKENDS = ("cpu", "gpu")

# <checkout>/.cache/jaxcache: a fixed path, because the directory is part of
# the cache key and a moving directory never hits.
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(_CHECKOUT, ".cache", "jaxcache")


def backend() -> str:
    """The default JAX backend, "cpu" or "gpu"; raises on any other."""
    name = jax.default_backend()
    if name not in SUPPORTED_BACKENDS:
        raise RuntimeError(
            f"unsupported JAX backend {name!r}: spleeterrt-tpu runs on "
            f"{' or '.join(SUPPORTED_BACKENDS)}"
        )
    return name


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and this
    sets nothing. Otherwise the cache lives at `DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
