"""slimt_tpu_torch — the PyTorch/CUDA port of slimt_tpu.

Runs the declared serving config of slimt_tpu on one NVIDIA GPU
(Hopper, sm_90a) with hand-written CUDA kernels for the int8 affine
and the whole encoder layer, and their plain PyTorch versions on the
CPU. The JAX package stays the reference; this package imports torch
and never jax (nor `regex`, which only the text processor needs).

    from slimt_tpu_torch import Model, Package, ModelConfig
    model = Model(ModelConfig(), Package(model=..., vocabulary=...), "cuda")
"""

from slimt_tpu.config import Config, ModelConfig, preset  # noqa: F401
from slimt_tpu_torch.models.model import Model, Package  # noqa: F401
