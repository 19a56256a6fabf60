"""Rotary position embeddings (port of ``llmtrain_tpu/ops/rope.py``).

Half-split ("rotate_half") layout, the HF-transformers/Llama convention:
the feature dim splits into two halves rather than interleaved pairs.
Angles are computed in f32 and the rotation runs in f32, casting back to
the input dtype — the JAX package's rounding points.
"""

from __future__ import annotations

import torch


def rope_angles(
    positions: torch.Tensor, head_dim: int, *, theta: float = 10000.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables, each ``positions.shape + (head_dim,)`` in f32."""
    if head_dim % 2 != 0:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    )
    inv_freq = 1.0 / (theta**exponent)
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    positions: torch.Tensor,
    *,
    theta: float = 10000.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q (B, T, H, Dh) and k (B, T, Hkv, Dh) by absolute positions:
    (T,) shared across the batch, or (B, T) per row."""
    cos, sin = rope_angles(positions, q.shape[-1], theta=theta)
    if positions.dim() == 1:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif positions.dim() == 2:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    else:
        raise ValueError(
            f"positions must be (T,) or (B, T), got shape {tuple(positions.shape)}"
        )

    def rot(x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)

    return rot(q), rot(k)


__all__ = ["apply_rope", "rope_angles"]
