"""Autoregressive sampling (port of ``llmtrain_tpu/generation.py``).

Two branches, chosen as in JAX (``generation.py:297``):

* **KV-cache decode** — the model exposes ``for_decoding()`` and prompt +
  ``max_new_tokens`` fits ``block_size``: prefill fills every layer's
  cache, then one token per step. Plain torch attention (the JAX decode
  path runs no Pallas kernel either), over the model's decode cache: a
  linear one spanning ``block_size``, the rolling one under a sliding
  window shorter than that, int8 codes with ``kv_cache_dtype: int8``
  (models/gpt.py).
* **Sliding-window re-forward** — everything else: a fixed-size token
  buffer, one full forward per new token over a window of
  ``min(block_size, total)`` positions ending at the longest current
  position. With ``attention: flash`` every forward runs the flash kernel
  in every layer.

Greedy decoding (``temperature=0``) is token-identical to JAX for the
same weights. Sampling draws from a ``torch.Generator`` (one per request,
seeded by the caller) in place of ``jax.random`` keys: the distribution
is the same, the draws are not.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def filter_logits(
    scaled: torch.Tensor,  # (..., V), already temperature-scaled
    *,
    top_k: int | None,
    top_p: float | None,
) -> torch.Tensor:
    """top-k / nucleus masking (-inf outside the kept set)."""
    neg_inf = torch.tensor(float("-inf"), dtype=scaled.dtype, device=scaled.device)
    if top_k is not None:
        k = min(top_k, scaled.shape[-1])
        kth = torch.topk(scaled, k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, neg_inf, scaled)
    if top_p is not None and top_p < 1.0:
        # Keep the smallest prefix of the descending-prob order whose
        # EXCLUSIVE cumulative mass is < top_p (always keeps the argmax).
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        exclusive = torch.cumsum(probs, dim=-1) - probs
        keep = exclusive < top_p
        thr = torch.where(keep, sorted_logits, -neg_inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < thr, neg_inf, scaled)
    return scaled


def _chosen_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """The model's logprob of the emitted token (raw log-softmax:
    temperature/top-k/top-p shape the choice, not the report)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return lp.gather(-1, tok[:, None].long())[:, 0]


def _sample_next(
    next_logits: torch.Tensor,  # (B, V) float32
    generator: torch.Generator,
    *,
    temperature: float,
    top_k: int | None,
    top_p: float | None = None,
) -> torch.Tensor:
    """One sampling decision, shared by both branches."""
    if temperature == 0.0:
        return torch.argmax(next_logits, dim=-1)
    scaled = filter_logits(next_logits / temperature, top_k=top_k, top_p=top_p)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _generate_cached(
    model: Any,
    prompt: torch.Tensor,  # (B, Tp)
    generator: torch.Generator,
    *,
    max_new_tokens: int,
    temperature: float,
    top_k: int | None,
    top_p: float | None,
    eos_token_id: int | None,
    with_logprobs: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    b, tp = prompt.shape
    # A linear cache spans block_size, as the paged engine's window and
    # speculative decoding's cache do, so their attention runs at
    # generate()'s shapes; a rolling cache holds the sliding window.
    decoder = model.for_decoding(cache_len=model.block_size)
    cache = decoder.init_cache(b)
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p)

    # Prefill: one forward over the whole prompt fills every layer's cache.
    logits = decoder(prompt, cache).float()
    tok = _sample_next(logits[:, -1], generator, **sample)
    tokens = [tok]
    lps = [_chosen_logprob(logits[:, -1], tok)] if with_logprobs else []
    done = torch.zeros(b, dtype=torch.bool, device=prompt.device)
    if eos_token_id is not None:
        done = tok == eos_token_id
    for _ in range(1, max_new_tokens):
        done_in = done  # rows already ended BEFORE this step
        logits = decoder(tok[:, None], cache).float()
        nxt = _sample_next(logits[:, 0], generator, **sample)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        if with_logprobs:
            lp = _chosen_logprob(logits[:, 0], nxt)
            if eos_token_id is not None:
                # Post-eos padding is not an emission: report 0.0.
                lp = torch.where(done_in, torch.zeros_like(lp), lp)
            lps.append(lp)
        tokens.append(nxt)
        tok = nxt
    out = torch.cat([prompt, torch.stack(tokens, dim=1)], dim=1)
    logprobs = (
        torch.stack(lps, dim=1) if with_logprobs
        else torch.zeros((b, 0), dtype=torch.float32, device=prompt.device)
    )
    return out, logprobs


def _generate_reforward(
    model: Any,
    buffer: torch.Tensor,  # (B, L) prompt left-aligned, zero-padded
    prompt_len: np.ndarray,  # (B,) host ints
    generator: torch.Generator,
    *,
    max_new_tokens: int,
    window_len: int,
    temperature: float,
    top_k: int | None,
    top_p: float | None,
    eos_token_id: int | None,
    with_logprobs: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    b, total_len = buffer.shape
    dev = buffer.device
    rows = torch.arange(b, device=dev)
    offsets = torch.arange(window_len, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    lps = torch.zeros((b, max_new_tokens if with_logprobs else 0), dtype=torch.float32,
                      device=dev)
    for i in range(max_new_tokens):
        done_in = done
        cur = prompt_len + i  # (B,) next position to fill
        # Fixed-size context window ending at the longest current position;
        # shorter rows read their logits at their own last token's index.
        hi = int(cur.max())
        start = int(np.clip(hi - window_len, 0, total_len - window_len))
        cur_t = torch.as_tensor(cur, device=dev)
        window = buffer[:, start : start + window_len]
        mask = (start + offsets)[None, :] < cur_t[:, None]
        logits = model(window, mask.to(torch.int32))  # (B, W, V)
        last_idx = torch.as_tensor(np.clip(cur - 1 - start, 0, window_len - 1), device=dev)
        next_logits = logits[rows, last_idx].float()
        next_tok = _sample_next(next_logits, generator, temperature=temperature,
                                top_k=top_k, top_p=top_p)
        if eos_token_id is not None:
            next_tok = torch.where(done, torch.full_like(next_tok, eos_token_id), next_tok)
            done = done | (next_tok == eos_token_id)
        buffer[rows, cur_t] = next_tok
        if with_logprobs:
            chosen = _chosen_logprob(next_logits, next_tok)
            if eos_token_id is not None:
                chosen = torch.where(done_in, torch.zeros_like(chosen), chosen)
            lps[:, i] = chosen
    return buffer, lps


def generate(
    model: Any,
    prompt_ids: np.ndarray,  # (B, Tp) or (Tp,)
    *,
    max_new_tokens: int,
    generator: torch.Generator | None = None,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_token_id: int | None = None,
    use_cache: bool | None = None,
    return_logprobs: bool = False,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Sample ``max_new_tokens`` continuations; returns (B, Tp+max_new_tokens)
    int32 ids (and (B, max_new_tokens) f32 logprobs with
    ``return_logprobs``).

    Same contract as the JAX ``generate``: ``temperature=0`` is greedy;
    ``top_k`` <= 0 and ``top_p`` outside (0, 1) disable their filters;
    ``use_cache=None`` picks the KV-cache branch when the model has
    ``for_decoding()`` and the output fits ``block_size``. ``generator``
    must live on the model's device (default: seeded with 0).
    """
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0; got {max_new_tokens}")
    ids = np.asarray(prompt_ids, dtype=np.int32)
    if ids.ndim == 1:
        ids = ids[None, :]
    b, tp = ids.shape
    if tp == 0:
        raise ValueError("prompt must contain at least one token")
    vocab_size = getattr(model, "vocab_size", None)
    if vocab_size is not None and (ids.min() < 0 or ids.max() >= vocab_size):
        raise ValueError(
            f"prompt token ids must be in [0, {vocab_size}); "
            f"got range [{ids.min()}, {ids.max()}]"
        )
    if top_k is not None and top_k <= 0:
        top_k = None  # CLI convention: 0 disables top-k filtering
    if top_p is not None and (top_p <= 0.0 or top_p >= 1.0):
        top_p = None  # out-of-band values disable the filter, like --top-k 0
    total = tp + max_new_tokens
    block_size = int(getattr(model, "block_size", total))
    window_len = min(block_size, total)

    cache_capable = hasattr(model, "for_decoding") and total <= block_size
    if use_cache is None:
        use_cache = cache_capable
    elif use_cache and not cache_capable:
        if not hasattr(model, "for_decoding"):
            raise ValueError(
                "use_cache=True needs a model exposing for_decoding(); "
                f"{type(model).__name__} does not"
            )
        raise ValueError(
            "use_cache=True needs prompt+max_new_tokens <= block_size "
            f"(got {total} > {block_size})"
        )

    if max_new_tokens == 0:
        empty_lp = np.zeros((b, 0), np.float32)
        return (ids.copy(), empty_lp) if return_logprobs else ids.copy()

    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    opts = dict(
        max_new_tokens=max_new_tokens,
        temperature=float(temperature),
        top_k=top_k,
        top_p=top_p,
        eos_token_id=eos_token_id,
        with_logprobs=return_logprobs,
    )
    with torch.inference_mode():
        if use_cache:
            prompt = torch.as_tensor(ids, dtype=torch.long, device=device)
            out, lps = _generate_cached(model, prompt, generator, **opts)
        else:
            buffer = torch.zeros((b, total), dtype=torch.long, device=device)
            buffer[:, :tp] = torch.as_tensor(ids, dtype=torch.long, device=device)
            prompt_len = np.full((b,), tp, dtype=np.int64)
            out, lps = _generate_reforward(
                model, buffer, prompt_len, generator, window_len=window_len, **opts
            )
        tokens = out.to(torch.int32).cpu().numpy()
        if return_logprobs:
            return tokens, lps.cpu().numpy()
        return tokens


__all__ = ["filter_logits", "generate"]
