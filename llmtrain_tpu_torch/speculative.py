"""Speculative decoding: draft-and-verify over two KV-cache models (port of
``llmtrain_tpu/speculative.py``).

A small DRAFT model proposes ``gamma`` tokens one at a time; the TARGET
model scores all of them in ONE call over ``gamma + 1`` positions; the
longest agreeing prefix is accepted and the first disagreement is
replaced by the target's own token. Each target call advances the decode
by 1..gamma+1 positions, and the output is exact:

* ``temperature == 0``: acceptance is argmax equality, and the tokens are
  those of ``generate()``'s greedy decoding from the target alone. On the
  card too: the target's logits for a position are the bits generate()
  computes for it (models/gpt.py runs every decode op at fixed shapes,
  and both decoders' caches span ``block_size`` or hold the sliding
  window).
* ``temperature > 0``: rejection sampling (Leviathan et al. / Chen et
  al.): a draft token x with draft probability q(x) and target
  probability p(x) is accepted with probability min(1, p/q); on a
  rejection the replacement is drawn from norm(max(p - q, 0)). Both
  models' logits go through the same temperature, top-k and top-p filter
  (:func:`_filtered_logprobs`), so every emitted token follows the
  target's filtered distribution. Draws come from one explicit
  ``torch.Generator`` (JAX folds a key per step): the distribution is
  JAX's, the draws are not.

JAX runs the loop as one ``lax.while_loop`` program; here it is a plain
Python loop over the port's decoders. Rollback is cursor-only
(``KVCache.set_cursor``): K/V written past the cursor is masked until it
is overwritten, in the linear and the rolling cache alike (a rolling
cache carries ``gamma + 1`` extra slots so that rolled-back writes never
evict a position a later window holds).

Scope: batch size 1. An ``eos_token_id`` stops at the first emitted eos
and fills the rest with eos, as ``generate()`` does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .generation import filter_logits


def _filtered_logprobs(logits: torch.Tensor, *, temperature: float, top_k: int | None,
                       top_p: float | None) -> torch.Tensor:
    """Log-probs after the temperature/top-k/top-p filter the plain sampler
    applies (generation.filter_logits), for draft and target alike."""
    scaled = filter_logits(logits.float() / temperature, top_k=top_k, top_p=top_p)
    return torch.log_softmax(scaled, dim=-1)


def _draw(probs: torch.Tensor, generator: torch.Generator) -> int:
    return int(torch.multinomial(probs, 1, generator=generator)[0])


def speculative_generate(
    model: Any,
    draft_model: Any,
    prompt: np.ndarray,
    *,
    max_new_tokens: int,
    gamma: int = 4,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_token_id: int | None = None,
    generator: torch.Generator | None = None,
    return_stats: bool = False,
) -> np.ndarray | tuple[np.ndarray, dict]:
    """Draft-and-verify decode; returns (1, Tp + max_new_tokens) int32 ids.

    ``model`` and ``draft_model`` are GPTs (each carrying its weights)
    exposing ``for_decoding()`` and sharing the vocabulary; ``gamma`` is
    the draft lookahead per target call. ``generator`` lives on the
    target's device (default: seeded with 0). ``return_stats=True`` also
    returns ``{"target_forwards": k, "mean_accepted": a}``: k target calls
    after the prefill, a the mean drafts accepted per call.
    """
    ids = np.asarray(prompt)
    if ids.ndim != 2 or ids.shape[0] != 1:
        raise ValueError(f"speculative decoding supports batch size 1, got shape {ids.shape}")
    if max_new_tokens <= 0:
        out = ids.copy()
        return (out, {"target_forwards": 0, "mean_accepted": 0.0}) if return_stats else out
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if top_k is not None and top_k <= 0:
        top_k = None
    if top_p is not None and (top_p <= 0.0 or top_p >= 1.0):
        top_p = None
    for m, label in ((model, "model"), (draft_model, "draft_model")):
        if not hasattr(m, "for_decoding"):
            raise ValueError(f"{label} must expose for_decoding() for KV caching")
    tp = ids.shape[1]
    total = tp + max_new_tokens
    for m, label in ((model, "target"), (draft_model, "draft")):
        if total + gamma + 1 > m.block_size:
            raise ValueError(
                f"prompt+max_new_tokens+gamma ({total + gamma + 1}) exceeds the "
                f"{label} model's block_size ({m.block_size})"
            )
    device = next(model.parameters()).device
    draft_device = next(draft_model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    greedy = temperature == 0.0
    filt = dict(temperature=temperature, top_k=top_k, top_p=top_p)

    # Linear caches span block_size as generate()'s do; a rolling cache
    # gets gamma + 1 slots of slack for the rolled-back writes.
    target = model.for_decoding(cache_len=model.block_size, ring_slack=gamma + 1)
    draft = draft_model.for_decoding(cache_len=draft_model.block_size, ring_slack=gamma + 1)
    cache, dcache = target.init_cache(1), draft.init_cache(1)
    buf = [int(t) for t in ids[0]]
    n, iterations = tp, 0

    def call(decoder: Any, kv: Any, tokens: list[int], dev: torch.device) -> torch.Tensor:
        return decoder(torch.tensor([tokens], dtype=torch.long, device=dev), kv)[0].float()

    with torch.inference_mode():
        # Loop invariant: both caches hold tokens 0..n-2 and their cursors
        # sit at n-1, whose token the next round feeds as its context.
        if tp > 1:
            call(target, cache, buf[:-1], device)
            call(draft, dcache, buf[:-1], draft_device)
        while n < total and not (eos_token_id is not None and n > tp
                                 and buf[n - 1] == eos_token_id):
            tok_in = buf[n - 1]
            drafts: list[int] = []
            q_rows: list[torch.Tensor] = []
            tok = tok_in
            for _ in range(gamma):
                logit = call(draft, dcache, [tok], draft_device)[0]
                if greedy:
                    tok = int(torch.argmax(logit))
                else:
                    lq = _filtered_logprobs(logit, **filt).to(device)
                    tok = _draw(lq.exp(), generator)
                    q_rows.append(lq)
                drafts.append(tok)
            # Feed the last draft too, so its K/V exists when the round is
            # accepted in full (else the draft cache keeps a hole there).
            call(draft, dcache, [tok], draft_device)
            t_logits = call(target, cache, [tok_in, *drafts], device)  # (gamma+1, V)
            if greedy:
                t_pred = torch.argmax(t_logits, dim=-1).tolist()
                accepted = 0
                while accepted < gamma and drafts[accepted] == t_pred[accepted]:
                    accepted += 1
                emitted = t_pred[: accepted + 1]
            else:
                lp = _filtered_logprobs(t_logits, **filt)  # (gamma+1, V)
                q_all = torch.stack(q_rows)  # (gamma, V)
                idx = torch.arange(gamma, device=device)
                chosen = torch.tensor(drafts, device=device)
                p_chosen, q_chosen = lp[idx, chosen], q_all[idx, chosen]
                uniforms = torch.rand(gamma, generator=generator, device=device)
                ratio = torch.exp(torch.clamp_max(p_chosen - q_chosen, 0.0))
                # A draft the target's filter removed (p = -inf) is rejected.
                ratio = torch.where(torch.isfinite(p_chosen), ratio, torch.zeros_like(ratio))
                ok = (uniforms < ratio).tolist()
                accepted = 0
                while accepted < gamma and ok[accepted]:
                    accepted += 1
                # Replacement from norm(max(p - q, 0)); past the last draft q
                # is 0, a fresh draw from p.
                p_row = lp[accepted].exp()
                q_row = q_all[accepted].exp() if accepted < gamma else torch.zeros_like(p_row)
                row = torch.clamp_min(p_row - q_row, 0.0)
                norm = row.sum()
                row = row / norm if float(norm) > 0 else p_row
                emitted = drafts[:accepted] + [_draw(row, generator)]
            buf[n:] = emitted
            n_new = n + accepted + 1
            if eos_token_id is not None and eos_token_id in emitted:
                n_new = n + emitted.index(eos_token_id) + 1
            cache.set_cursor(n_new - 1)
            dcache.set_cursor(n_new - 1)
            n = n_new
            iterations += 1

    out = buf[:total]
    if eos_token_id is not None:
        out = buf[:n] + [eos_token_id] * (total - n) if n < total else out
    tokens = np.asarray([out], np.int32)
    if return_stats:
        emitted_total = min(n - tp, max_new_tokens)
        mean_accepted = emitted_total / iterations - 1.0 if iterations else 0.0
        return tokens, {"target_forwards": iterations,
                        "mean_accepted": round(mean_accepted, 4)}
    return tokens


__all__ = ["speculative_generate"]
