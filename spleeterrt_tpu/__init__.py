"""spleeterrt-tpu: music source separation in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
james34602/SpleeterRT (reference: C/pthreads/BLAS, CPU-only): offline and
streaming Spleeter U-Net source separation (vocals / drums / bass /
accompaniment) at 44.1 kHz, for an NVIDIA GPU:

- batched rFFT STFT/iSTFT instead of a hand-unrolled Hartley codelet
  (reference: Executable/codelet.c, Executable/stftFix.c),
- one batched U-Net forward over all spectrogram tiles and stems (cuDNN
  convolutions) instead of per-thread replicas + im2col/GEMM
  (reference: Executable/spleeter.c, Executable/main.c:444-674),
- `jax.sharding.Mesh` + collectives for scale instead of pthread pools
  (reference: Executable/cpthread.c),
- a `lax.scan` streaming engine with the reference's double-buffer
  one-block-delay semantics (reference: VST/Source/Spleeter4Stems.c).
"""

from spleeterrt_tpu.config import SeparatorConfig, TransformConfig
from spleeterrt_tpu.core import transform, model, separate, weights

__version__ = "0.1.0"

__all__ = [
    "SeparatorConfig",
    "TransformConfig",
    "transform",
    "model",
    "separate",
    "weights",
]
