"""The port's flash-attention backward against the Pallas TPU kernels.

On the CPU the port's wrappers run their plain versions (the CUDA dq and
dk/dv kernels are held against those plain versions on the card by
chip_smoke.py); here the plain version is held against
``pallas_flash_attention_bwd`` in interpret mode, which runs the TPU
kernels' own logic on the CPU, with small blocks, on the same (out, lse)
and cotangent. Tolerance: f32 atol 1e-5, rtol 1e-4 (the two differ only
in summation order). The autograd function is held against ``jax.vjp`` of
JAX's ``flash_attention`` (which differentiates its blockwise path on the
CPU) at the same band. Padded query rows get a zero cotangent, as the
model's output mask gives them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from llmtrain_tpu.ops.pallas_attention import (
    pallas_flash_attention_bwd,
    pallas_flash_attention_fwd,
)
from llmtrain_tpu_torch.ops import flash_attention as flash_ops

B, T, H, D = 2, 32, 4, 8
ATOL, RTOL = 1e-5, 1e-4


def _inputs(hkv: int, case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    mask, window = None, 0
    if case == "window":
        window = 8
    elif case == "segments":
        # Row 0: two documents then padding; row 1: one document then padding.
        mask = np.zeros((B, T), np.int32)
        mask[0, :20], mask[0, 20:28] = 1, 2
        mask[1, :25] = 1
        g = g * (mask != 0)[:, :, None, None]
    return q, k, v, g, mask, window


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("case", ["causal", "window", "segments"])
def test_plain_backward_matches_pallas(hkv: int, case: str) -> None:
    q, k, v, g, mask, window = _inputs(hkv, case)
    jmask = None if mask is None else jnp.asarray(mask)
    kw = dict(causal=True, block_q=16, block_k=16, interpret=True, window=window)
    j_out, j_lse = pallas_flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              jmask, **kw)
    j_dq, j_dk, j_dv = pallas_flash_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_out, j_lse, jnp.asarray(g), jmask, **kw
    )
    # Same (out, lse) on both sides: the backward is what is compared.
    t = [torch.from_numpy(np.array(x)) for x in (q, k, v, j_out, j_lse, g)]
    t_dq, t_dk, t_dv = flash_ops.flash_attention_bwd(
        *t, None if mask is None else torch.from_numpy(mask), causal=True, window=window
    )
    assert t_dk.shape == (B, T, hkv, D) and t_dk.dtype == torch.float32
    for ours, theirs in ((t_dq, j_dq), (t_dk, j_dk), (t_dv, j_dv)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL, rtol=RTOL)


def test_dq_and_dkdv_wrappers_take_the_plain_version_on_cpu() -> None:
    q, k, v, g, mask, _ = _inputs(2, "segments", seed=1)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = flash_ops.flash_attention_fwd(tq, tk, tv, tm)
    delta = flash_ops.attention_delta(out, tg)
    before = (flash_ops.flash_attention_bwd_dq.launches, flash_ops.flash_attention_bwd_dkdv.launches)
    dq = flash_ops.flash_attention_bwd_dq(tq, tk, tv, tg, lse, delta, tm)
    dk, dv = flash_ops.flash_attention_bwd_dkdv(tq, tk, tv, tg, lse, delta, tm)
    ref = flash_ops.flash_attention_bwd_reference(tq, tk, tv, out, lse, tg, tm)
    for got, want in zip((dq, dk, dv), ref):
        assert torch.equal(got, want)
    after = (flash_ops.flash_attention_bwd_dq.launches, flash_ops.flash_attention_bwd_dkdv.launches)
    assert after == before


@pytest.mark.parametrize("hkv, case", [(4, "causal"), (2, "window"), (1, "segments")])
def test_autograd_function_matches_jax_vjp(hkv: int, case: str) -> None:
    q, k, v, g, mask, window = _inputs(hkv, case, seed=2)

    def jax_fn(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, attention_mask=None if mask is None
                                  else jnp.asarray(mask), window=window)
        if mask is not None:
            out = out * (jnp.asarray(mask) != 0)[:, :, None, None]
        return out

    j_out, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_ops.flash_attention(tq, tk, tv, window=window,
                                    attention_mask=None if mask is None else torch.from_numpy(mask))
    if mask is not None:
        out = out * (torch.from_numpy(mask) != 0)[:, :, None, None]
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=ATOL, rtol=RTOL)
    for ours, theirs in zip((tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL, rtol=RTOL)


def test_ragged_length_gradients_match_autograd_of_plain_attention() -> None:
    """Any T >= 1: T = 13 (no block divides it) against torch autograd
    through full-matrix softmax attention."""
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((1, 13, 2, 8)).astype(np.float32) for _ in range(4))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    flash_ops.flash_attention(tq, tk, tv).backward(torch.from_numpy(g))
    rq, rk, rv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", rq, rk) / np.sqrt(8)
    s = s.masked_fill(~torch.ones(13, 13, dtype=torch.bool).tril(), float("-inf"))
    torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), rv).backward(torch.from_numpy(g))
    for ours, theirs in ((tq.grad, rq.grad), (tk.grad, rk.grad), (tv.grad, rv.grad)):
        torch.testing.assert_close(ours, theirs, atol=ATOL, rtol=RTOL)
