"""The port's flash-attention forward against the Pallas TPU kernel.

On the CPU the port's wrapper runs its plain version (the CUDA kernel is
held against that plain version on the card by chip_smoke.py); here the
plain version is held against ``pallas_flash_attention_fwd`` in interpret
mode, which runs the TPU kernel's own logic on the CPU, with small blocks
as tests/test_ops.py does. Tolerances: f32 O and lse at 1e-5 (the two
differ only in summation order); bf16 O at 2e-2 (one bf16 rounding of
outputs of magnitude ~1, the band of test_ops.py::test_bf16), bf16 lse at
1e-5 (it is computed in f32 from the same bf16 inputs). O is compared on
live query rows only (the model zeroes the rest), lse on every row whose
query has a live key.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.ops.pallas_attention import pallas_flash_attention_fwd
from llmtrain_tpu_torch.ops import flash_attention as flash_ops

B, T, H, D = 2, 32, 4, 8


def _inputs(hkv: int, case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    mask, window = None, 0
    if case == "window":
        window = 8
    elif case == "segments":
        # Row 0: two documents then padding; row 1: one document then padding.
        mask = np.zeros((B, T), np.int32)
        mask[0, :20], mask[0, 20:28] = 1, 2
        mask[1, :25] = 1
    return q, k, v, mask, window


def _compare(q, k, v, mask, window, dtype, atol_o):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j_out, j_lse = pallas_flash_attention_fwd(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        None if mask is None else jnp.asarray(mask),
        causal=True, block_q=16, block_k=16, interpret=True, window=window,
    )
    t_out, t_lse = flash_ops.flash_attention_fwd(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), None if mask is None else torch.from_numpy(mask),
        causal=True, window=window,
    )
    assert t_out.dtype == dtype and t_out.shape == (B, T, H, D)
    assert t_lse.dtype == torch.float32 and t_lse.shape == (B * H, T)
    live = np.ones((B, T), bool) if mask is None else mask != 0
    j_o = np.asarray(j_out, dtype=np.float32)
    np.testing.assert_allclose(t_out.float().numpy()[live], j_o[live], atol=atol_o, rtol=0)
    j_l = np.asarray(j_lse).reshape(B, H, T).transpose(0, 2, 1)
    t_l = t_lse.numpy().reshape(B, H, T).transpose(0, 2, 1)
    np.testing.assert_allclose(t_l[live], j_l[live], atol=1e-5, rtol=0)


@pytest.mark.parametrize("hkv", [4, 2, 1])
@pytest.mark.parametrize("case", ["causal", "window", "segments"])
def test_plain_matches_pallas_f32(hkv: int, case: str) -> None:
    q, k, v, mask, window = _inputs(hkv, case)
    _compare(q, k, v, mask, window, torch.float32, atol_o=1e-5)


@pytest.mark.parametrize("hkv", [4, 1])
def test_plain_matches_pallas_bf16(hkv: int) -> None:
    q, k, v, mask, window = _inputs(hkv, "segments", seed=1)
    # Round the inputs to bf16 once so both sides see identical operands.
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in (q, k, v))
    _compare(q, k, v, mask, window, torch.bfloat16, atol_o=2e-2)


def test_cpu_dispatch_takes_plain_version_and_counts_nothing() -> None:
    q, k, v, _, _ = _inputs(2, "causal")
    before = flash_ops.flash_attention_fwd.launches
    out = flash_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    ref, _ = flash_ops.flash_attention_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    )
    assert torch.equal(out, ref)
    assert flash_ops.flash_attention_fwd.launches == before


def test_ragged_length_masks_the_tail() -> None:
    """Any T >= 1: a length no block divides (the kernel masks its tail)
    still matches full-matrix attention."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 13, 2, 8)).astype(np.float32))
               for _ in range(3))
    out, _ = flash_ops.flash_attention_fwd(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    s = s.masked_fill(~torch.ones(13, 13, dtype=torch.bool).tril(), float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(window=-1), "window must be >= 0"),
        (dict(window=4, causal=False), "requires causal"),
    ],
)
def test_invalid_arguments_raise(kwargs, match) -> None:
    q, k, v, _, _ = _inputs(4, "causal")
    with pytest.raises(ValueError, match=match):
        flash_ops.flash_attention_fwd(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kwargs
        )


def test_gqa_head_mismatch_raises() -> None:
    q, k, v, _, _ = _inputs(4, "causal")
    with pytest.raises(ValueError, match="multiple of n_kv_heads"):
        flash_ops.flash_attention_fwd(
            torch.from_numpy(q), torch.from_numpy(k[:, :, :3]), torch.from_numpy(v[:, :, :3])
        )


def test_non_cpu_non_cuda_tensor_raises() -> None:
    from torch_port_helpers import foreign_device_tensor

    q = foreign_device_tensor((1, 4, 2, 64))
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_ops.flash_attention_fwd(q, q, q)


def test_kernel_operands_must_be_16_byte_aligned() -> None:
    """The kernels copy q/k/v/dO rows in 16-byte cp.async chunks; a
    contiguous view that starts off a 16-byte boundary is refused before
    any launch."""
    buf = torch.zeros(1 + 64 * 2 * 64, dtype=torch.bfloat16)
    q = buf[1:].view(1, 64, 2, 64)  # contiguous, 2 bytes past the allocation
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    ok = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_ops._check_kernel_operands({"q": q, "k": ok, "v": ok}, None, q.dtype, 64)
    assert flash_ops._check_kernel_operands({"q": ok, "k": ok, "v": ok}, None, ok.dtype, 64) is None
