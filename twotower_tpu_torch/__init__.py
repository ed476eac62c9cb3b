"""PyTorch/CUDA port of the two-tower retrieval engine, for NVIDIA Hopper.

A package of its own beside ``twotower_tpu`` (the JAX reference): it imports
``torch`` and never JAX or the JAX package. The fused in-batch loss runs as
hand-written CUDA kernels (``ops/csrc/``) on the GPU and as plain PyTorch on
the CPU. Entry points (the train step, the ``Trainer`` and ``Evaluator``,
``python -m twotower_tpu_torch.training.train`` and ``...evaluation.evaluate``)
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from twotower_tpu_torch.config import Config, load_config

__version__ = "0.1.0"

__all__ = ["Config", "load_config", "__version__"]
