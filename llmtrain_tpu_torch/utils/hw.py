"""Peak FLOP/s of the card and MFU arithmetic (port of
``llmtrain_tpu/utils/hw.py``).

The JAX module looks up bf16 peaks by TPU generation; the port runs on an
NVIDIA H100, whose dense bf16 tensor-core peak is 989 TFLOP/s (NVIDIA
H100 SXM datasheet, without sparsity). That peak assumes the card's full
700 W power limit; a card set below it reaches less, so the MFU computed
here is against the published peak. On the CPU (tests) a nominal figure
keeps the arithmetic defined; it is not a device metric.
"""

from __future__ import annotations

import torch

H100_PEAK_BF16_FLOPS = 989e12  # NVIDIA H100 SXM datasheet, dense bf16
CPU_NOMINAL_FLOPS = 2e11  # placeholder for CPU runs; not a measurement


def peak_flops(device: torch.device) -> float:
    """bf16 peak FLOP/s of the card the run is on (the H100 figure for a
    CUDA device), or the nominal CPU placeholder."""
    return H100_PEAK_BF16_FLOPS if device.type == "cuda" else CPU_NOMINAL_FLOPS


def transformer_flops_per_token(
    *,
    n_params: int,
    n_layers: int,
    seq_len: int,
    d_model: int,
    n_trainable_params: int | None = None,
) -> float:
    """Training FLOPs/token ~ 4N + 2n + 12*L*T*d (PaLM appendix B; the
    weight-gradient term counts only the ``n`` trainable parameters)."""
    n_t = n_params if n_trainable_params is None else n_trainable_params
    return 4.0 * n_params + 2.0 * n_t + 12.0 * n_layers * seq_len * d_model


def mfu(
    tokens_per_sec_per_chip: float,
    *,
    n_params: int,
    n_layers: int,
    seq_len: int,
    d_model: int,
    peak_flops: float,
    n_trainable_params: int | None = None,
) -> float:
    """Model FLOPs utilization of one card at the given throughput."""
    flops_per_token = transformer_flops_per_token(
        n_params=n_params,
        n_layers=n_layers,
        seq_len=seq_len,
        d_model=d_model,
        n_trainable_params=n_trainable_params,
    )
    return tokens_per_sec_per_chip * flops_per_token / peak_flops


def peak_memory_bytes(device: torch.device) -> float:
    """High-water mark of allocated device memory on ``device``
    (``torch.cuda.max_memory_allocated``); 0.0 on the CPU."""
    if device.type != "cuda":
        return 0.0
    return float(torch.cuda.max_memory_allocated(device))


__all__ = [
    "CPU_NOMINAL_FLOPS",
    "H100_PEAK_BF16_FLOPS",
    "mfu",
    "peak_flops",
    "peak_memory_bytes",
    "transformer_flops_per_token",
]
