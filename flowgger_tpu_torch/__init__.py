"""flowgger_tpu_torch: the PyTorch / CUDA port of flowgger_tpu.

The same collector — transports → framing → decode → encode → queue →
sinks, driven by the same TOML config — with the hot path on an NVIDIA
GPU: device framing and the RFC5424 decode run as hand-written CUDA
kernels (``csrc/``), built from source at first use.  The JAX package
(``flowgger_tpu``) is the reference; this package imports nothing from
it and nothing of JAX.

Public API mirrors the reference's single entry point:
``flowgger_tpu_torch.start(config_path, device=None)`` (``cuda`` unless
``device="cpu"`` is asked for).
"""

from .pipeline import start

__version__ = "0.1.0"

__all__ = ["start", "__version__"]
