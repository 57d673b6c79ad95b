"""slimt_tpu_torch — the PyTorch/CUDA port of slimt_tpu.

Runs slimt_tpu's serving paths on one NVIDIA GPU (Hopper, sm_90a) with
hand-written CUDA kernels, and their plain PyTorch versions on the
CPU. The JAX package stays the reference; this package imports torch
and never jax, nor anything of slimt_tpu: it carries its own copies of
the config, io, text, html and runtime modules. `regex` is imported
only by the sentence splitter, on first use.

    from slimt_tpu_torch import Blocking, Config, Model, ModelConfig, Package
    model = Model(ModelConfig(), Package(model=..., vocabulary=...), device="cuda")
    with Blocking(Config()) as service:
        responses = service.translate(model, ["hello world"])

The JAX package's front doors are here too, on the card by default:
`python -m slimt_tpu_torch translate --root pkg/` (and synth, convert,
inspect, ls, download, serve, route), `slimt_tpu_torch.server`,
`slimt_tpu_torch.runtime.router` and the C ABI and the JNI layer (`slimt_tpu_torch/native/`, `capi.py`).
"""

from slimt_tpu_torch.config import Config, ModelConfig, preset  # noqa: F401
from slimt_tpu_torch.models.model import Model, Package  # noqa: F401
from slimt_tpu_torch.runtime.service import Async, Blocking  # noqa: F401
