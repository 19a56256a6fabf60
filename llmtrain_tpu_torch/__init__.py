"""llmtrain_tpu_torch — the PyTorch/CUDA port of ``llmtrain_tpu``.

The JAX package beside it is the reference; this package is its port to
PyTorch on an NVIDIA H100, one slice at a time (ROADMAP.md). Module paths
mirror the JAX package's, so ``llmtrain_tpu_torch/models/gpt.py`` is the
counterpart of ``llmtrain_tpu/models/gpt.py``. Every TPU (Pallas) kernel
on a ported path becomes a hand-written CUDA kernel under ``csrc/``.

Slice 1 serves a trained GPT: the ``generate`` and ``serve`` (simple mode)
entry points, with flash-attention forward as a CUDA kernel for sm_90a.
The package imports torch, numpy, PyYAML, Pydantic and msgpack — never
jax, flax, optax or llmtrain_tpu.
"""

__version__ = "0.1.0"
