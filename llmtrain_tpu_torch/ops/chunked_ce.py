"""Chunked (vocab-blocked) cross-entropy: the CE loss without (B, T, V)
tensors, in plain PyTorch (port of ``llmtrain_tpu/ops/chunked_ce.py``).

The loss streams over ``chunk``-wide vocab chunks with a running
logsumexp; its ``torch.autograd.Function`` recomputes each chunk's logits
in the backward to accumulate dhidden and dW in f32, so peak memory is
O(B*T*chunk). JAX leaves this to XLA (a ``lax.scan``), not to a Pallas
kernel, so the port has no kernel here: each chunk product is a
``torch.matmul`` of the compute-dtype operands upcast to f32 (the values
of JAX's ``preferred_element_type=f32`` product). The label logit and
its gradient go through a gather and an ``index_add_``, as JAX's ``take``
and scatter-add do.
"""

from __future__ import annotations

import torch

from .fused_ce import g_lse_from, masked_sums

DEFAULT_CHUNK = 8192


def _label_logit(h: torch.Tensor, w_vocab: torch.Tensor, labels: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    label_emb = w_vocab[labels.long()].to(dtype)  # (B, T, d)
    return (h.float() * label_emb.float()).sum(dim=-1)


def _forward(hidden, w_vocab, labels, chunk, compute_dtype, z_loss):
    v = w_vocab.shape[0]
    dt = compute_dtype or hidden.dtype
    hf = hidden.to(dt).float()
    m = torch.full(labels.shape, float("-inf"), dtype=torch.float32, device=hidden.device)
    s = torch.zeros_like(m)
    for base in range(0, v, chunk):
        logits = hf @ w_vocab[base : base + chunk].to(dt).float().T
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(dim=-1)
        m = m_new
    lse = m + torch.log(s)
    per_token = lse - _label_logit(hidden.to(dt), w_vocab, labels, dt)
    if z_loss > 0.0:
        per_token = per_token + z_loss * lse.square()
    return per_token, lse


class _ChunkedCE(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves (hidden, W, labels, lse);
    the backward recomputes each chunk's softmax, accumulates dh and the
    chunk's dW in f32, then applies the -label_logit term (dh -= g *
    W[label], dW[label] -= g * hidden)."""

    @staticmethod
    def forward(ctx, hidden, w_vocab, labels, chunk, compute_dtype, z_loss):  # noqa: ANN001 — autograd API
        per_token, lse = _forward(hidden, w_vocab, labels, chunk, compute_dtype, z_loss)
        ctx.save_for_backward(hidden, w_vocab, labels, lse)
        ctx.config = (chunk, compute_dtype, z_loss)
        return per_token

    @staticmethod
    def backward(ctx, grad):  # noqa: ANN001 — autograd API
        hidden, w_vocab, labels, lse = ctx.saved_tensors
        chunk, compute_dtype, z_loss = ctx.config
        v, d = w_vocab.shape
        dt = compute_dtype or hidden.dtype
        hf = hidden.to(dt).float()
        g = grad.float()
        g_lse = g_lse_from(g, lse, z_loss)
        dh = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device)
        dw = torch.zeros((v, d), dtype=torch.float32, device=hidden.device)
        for base in range(0, v, chunk):
            w_c = w_vocab[base : base + chunk].to(dt).float()
            logits = hf @ w_c.T
            gp = torch.exp(logits - lse[..., None]) * g_lse[..., None]
            dh += gp @ w_c
            dw[base : base + chunk] = gp.reshape(-1, gp.shape[-1]).T @ hf.reshape(-1, d)
        dh -= g[..., None] * w_vocab[labels.long()].float()
        dw.index_add_(0, labels.reshape(-1).long(),
                      (-g[..., None] * hidden.float()).reshape(-1, d))
        return dh.to(hidden.dtype), dw.to(w_vocab.dtype), None, None, None, None


def chunked_ce_per_token(
    hidden: torch.Tensor,
    w_vocab: torch.Tensor,
    labels: torch.Tensor,
    chunk: int = DEFAULT_CHUNK,
    compute_dtype: torch.dtype | None = None,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Per-token CE loss, f32, shape (B, T). hidden: (B, T, d) post-final
    norm; w_vocab: (V, d) embedding layout; labels: (B, T) ids. ``z_loss``
    adds ``z_loss * lse^2`` per token."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return _ChunkedCE.apply(hidden, w_vocab, labels, chunk, compute_dtype, z_loss)


def chunked_ce_components(
    hidden: torch.Tensor,
    w_vocab: torch.Tensor,
    labels: torch.Tensor,
    attention_mask: torch.Tensor | None,
    *,
    chunk: int = DEFAULT_CHUNK,
    z_loss: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example ``(loss_sum, token_count)`` of shape (B,), the
    mask-aware contract of ``masked_ce_components``."""
    per_token = chunked_ce_per_token(hidden, w_vocab, labels, chunk, None, z_loss)
    return masked_sums(per_token, attention_mask)


__all__ = ["DEFAULT_CHUNK", "chunked_ce_components", "chunked_ce_per_token"]
