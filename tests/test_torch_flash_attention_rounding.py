"""The rounding points of the bf16 tensor-core flash kernels, rehearsed on the CPU.

The bf16 instances of the forward, dQ and dK/dV CUDA kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``) run
their products on the tensor cores: bf16 operands, f32 sums. Beside the
bf16 inputs and outputs, that adds roundings the f32 plain version does
not have: P is rounded to bf16 before P V (forward, per 64-key tile,
relative to the running row max), P and dS are rounded to bf16 before
dV = P^T dO and dK = scale * dS^T q, and dS before dQ = scale * dS k
(backward). S is scaled in f32 after the product (the plain version, as
Pallas does, scales q before it), dK's and dQ's scale is applied to the
f32 sums at the end, and the row sum is taken from the f32 P.

``_kernel_forward``, ``_kernel_dkdv`` and ``_kernel_dq`` below repeat the
kernels' arithmetic at those points in plain torch; the tests hold them
against the f32 plain version (``flash_attention_fwd_reference``,
``flash_attention_bwd_reference``) with the limits ``chip_smoke.py`` holds
the kernels to on the card: O within 2e-2 on live rows, lse within 1e-4,
dQ, dK and dV within 2^-7 of the largest magnitude. The same f32 plain version
is held against the JAX Pallas kernels in interpret mode at 1e-5 (f32,
summation order only), as tests/test_torch_flash_attention.py and
tests/test_torch_flash_attention_bwd.py do at a smaller size.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.ops.pallas_attention import (
    pallas_flash_attention_bwd,
    pallas_flash_attention_fwd,
)
from llmtrain_tpu_torch.ops import flash_attention as flash_ops

B, T, H = 2, 512, 2
KEY_TILE = 64  # keys per tile of the forward kernel
ATOL_O, ATOL_LSE, BWD_RTOL = 2e-2, 1e-4, 2**-7
CASES = ["causal", "window", "gqa", "segments"]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).float()


def _inputs(d: int, case: str, seed: int = 0):
    """bf16-valued f32 q, k, v, dO from a numpy seed; the (B, T) segment
    ids (two documents, padding at the end of row 0) and the window."""
    rng = np.random.default_rng(seed)
    hkv = 1 if case == "gqa" else H
    q, k, v, g = (
        _bf16(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
        for shape in ((B, T, H, d), (B, T, hkv, d), (B, T, hkv, d), (B, T, H, d))
    )
    mask, window = None, 0
    if case == "window":
        window = 100
    elif case == "segments":
        mask = np.ones((B, T), np.int32)
        mask[:, T // 3 :] = 2
        mask[0, T - 37 :] = 0
        mask = torch.from_numpy(mask)
        g = g * (mask != 0)[:, :, None, None]
    return q, k, v, g, mask, window


def _scores(q, k, mask, window):
    """(B, Hkv, G, Tq, Tk) scale * q k^T in f32, dead logits at -1e30."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, t, hkv, h // hkv, d), k)
    s = s * (1.0 / math.sqrt(d))
    live = flash_ops._live(t, mask, True, window, q.device)
    return torch.where(live, s, torch.full_like(s, flash_ops.NEG_INF))


def _kernel_forward(q, k, v, mask, window):
    """The forward kernel's arithmetic: online softmax over 64-key tiles,
    P rounded to bf16 before P V, the row sum from the f32 P, O rounded to
    bf16 at the end; lse = m + log(l) in f32."""
    b, t, h, d = q.shape
    s = _scores(q, k, mask, window)
    row_max = torch.full(s.shape[:-1], flash_ops.NEG_INF)
    row_sum = torch.zeros(s.shape[:-1])
    acc = torch.zeros((*s.shape[:-1], d))
    for n0 in range(0, t, KEY_TILE):
        tile = s[..., n0 : n0 + KEY_TILE]
        new_max = torch.maximum(row_max, tile.amax(dim=-1))
        correction = torch.exp(row_max - new_max)
        p = torch.exp(tile - new_max[..., None])
        row_sum = row_sum * correction + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", _bf16(p), v[:, n0 : n0 + KEY_TILE])
        acc = acc * correction[..., None] + pv
        row_max = new_max
    out = _bf16(acc / row_sum[..., None]).permute(0, 3, 1, 2, 4).reshape(b, t, h, d)
    lse = (row_max + torch.log(row_sum)).reshape(b * h, t)
    return out, lse


def _kernel_dkdv(q, k, v, dout, lse, delta, mask, window):
    """The dK/dV kernel's arithmetic: P = exp(S - lse) and dS = P (dP -
    delta) in f32, each rounded to bf16 before its product with dO or q,
    the query group summed in f32, dK's scale on the f32 sum, dK and dV
    rounded to bf16 at the end."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    s = _scores(q, k, mask, window)
    p = torch.exp(s - lse.reshape(b, hkv, g, t, 1))
    dof = dout.reshape(b, t, hkv, g, d)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v)
    ds = p * (dp - delta.reshape(b, hkv, g, t, 1))
    dv = torch.einsum("bkgqs,bqkgd->bskd", _bf16(p), dof)
    dk = torch.einsum("bkgqs,bqkgd->bskd", _bf16(ds), q.reshape(b, t, hkv, g, d))
    return _bf16(dk * (1.0 / math.sqrt(d))), _bf16(dv)


def _kernel_dq(q, k, v, dout, lse, delta, mask, window):
    """The dQ kernel's arithmetic: S = q k^T scaled in f32 after the
    product, P = exp(S - lse) and dS = P (dP - delta) in f32, dS rounded to
    bf16 before dS k, the scale on the f32 sum, dQ rounded to bf16."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    s = _scores(q, k, mask, window)
    p = torch.exp(s - lse.reshape(b, hkv, g, t, 1))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dout.reshape(b, t, hkv, g, d), v)
    ds = p * (dp - delta.reshape(b, hkv, g, t, 1))
    dq = torch.einsum("bkgqs,bskd->bqkgd", _bf16(ds), k)
    return _bf16(dq * (1.0 / math.sqrt(d))).reshape(b, t, h, d)


def _live_rows(mask):
    return torch.ones(B, T, dtype=torch.bool) if mask is None else mask != 0


def _rel(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_kernel_rounding_points_fit_the_limits(d: int, case: str) -> None:
    q, k, v, g, mask, window = _inputs(d, case)
    ref_out, ref_lse = flash_ops.flash_attention_fwd_reference(q, k, v, mask, window=window)
    out, lse = _kernel_forward(q, k, v, mask, window)
    live = _live_rows(mask)
    assert (out - ref_out).abs()[live].max().item() <= ATOL_O
    lse_err = (lse - ref_lse).reshape(B, H, T).transpose(1, 2)[live].abs().max().item()
    assert lse_err <= ATOL_LSE
    # The backward takes each side's own (out, lse), as the kernels take
    # the forward kernel's.
    _, ref_dk, ref_dv = flash_ops.flash_attention_bwd_reference(
        q, k, v, ref_out, ref_lse, g, mask, window=window
    )
    delta = flash_ops.attention_delta(out, g)
    dk, dv = _kernel_dkdv(q, k, v, g, lse, delta, mask, window)
    assert _rel(dk, ref_dk) <= BWD_RTOL
    assert _rel(dv, ref_dv) <= BWD_RTOL
    # And the roundings are there: the kernel arithmetic is not the f32 one.
    assert _rel(dv, ref_dv) > 0.0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_dq_rounding_points_fit_the_limit(d: int, case: str) -> None:
    q, k, v, g, mask, window = _inputs(d, case, seed=2)
    ref_out, ref_lse = flash_ops.flash_attention_fwd_reference(q, k, v, mask, window=window)
    ref_dq, _, _ = flash_ops.flash_attention_bwd_reference(
        q, k, v, ref_out, ref_lse, g, mask, window=window
    )
    # The kernel side takes the forward kernel's (out, lse), as on the card.
    out, lse = _kernel_forward(q, k, v, mask, window)
    dq = _kernel_dq(q, k, v, g, lse, flash_ops.attention_delta(out, g), mask, window)
    assert _rel(dq, ref_dq) <= BWD_RTOL
    assert _rel(dq, ref_dq) > 0.0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_at_the_kernel_shape(d: int, case: str) -> None:
    q, k, v, g, mask, window = _inputs(d, case, seed=1)
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    kw = dict(causal=True, block_q=128, block_k=128, interpret=True, window=window)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    j_out, j_lse = pallas_flash_attention_fwd(jq, jk, jv, jmask, **kw)
    ref_out, ref_lse = flash_ops.flash_attention_fwd_reference(q, k, v, mask, window=window)
    live = _live_rows(mask).numpy()
    np.testing.assert_allclose(ref_out.numpy()[live], np.asarray(j_out)[live], atol=1e-5, rtol=0)
    j_l = np.asarray(j_lse).reshape(B, H, T).transpose(0, 2, 1)
    r_l = ref_lse.numpy().reshape(B, H, T).transpose(0, 2, 1)
    np.testing.assert_allclose(r_l[live], j_l[live], atol=1e-5, rtol=0)
    # Backward on the same (out, lse) and cotangent on both sides.
    _, j_dk, j_dv = pallas_flash_attention_bwd(
        jq, jk, jv, j_out, j_lse, jnp.asarray(g.numpy()), jmask, **kw
    )
    t_out, t_lse = (torch.from_numpy(np.array(x)) for x in (j_out, j_lse))
    _, dk, dv = flash_ops.flash_attention_bwd_reference(
        q, k, v, t_out, t_lse, g, mask, window=window
    )
    for ours, theirs in ((dk, j_dk), (dv, j_dv)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5, rtol=1e-4)


def test_smoke_counts_tensor_core_instructions_per_kernel() -> None:
    """chip_smoke.py's build phase reads cuobjdump's SASS and ptxas's
    report per kernel; a kernel without HMMA/HGMMA counts 0. It checks nine
    bf16 instances, each found by a fragment of its mangled name that the
    f32 instance of the same kernel does not contain."""
    import chip_smoke

    instances = {
        label: tag
        for kernels in chip_smoke.TENSOR_CORE_KERNELS.values()
        for label, tag in (chip_smoke.tensor_core_instance(k, dims) for k, dims in kernels)
    }
    assert sorted(instances) == sorted([
        "flash_fwd_kernel<64, bf16>", "flash_fwd_kernel<128, bf16>",
        "flash_bwd_dq_kernel<64, bf16>", "flash_bwd_dq_kernel<128, bf16>",
        "flash_bwd_dkdv_kernel<64, bf16>", "flash_bwd_dkdv_kernel<128, bf16>",
        "fused_ce_fwd_kernel<bf16>", "fused_ce_bwd_dh_kernel<bf16>",
        "fused_ce_bwd_dw_kernel<bf16>",
    ])
    mangled = {
        "fused_ce_fwd_kernel<bf16>": (
            "_ZN44_GLOBAL__N__3a0583f4_11_fused_ce_cu_935e5b8619fused_ce_fwd_kernel"
            "I13__nv_bfloat16EEvPKT_S4_PKiPfS7_iii",
            "_ZN44_GLOBAL__N__3a0583f4_11_fused_ce_cu_935e5b8619fused_ce_fwd_kernel"
            "IfEEvPKT_S3_PKiPfS6_iii",
        ),
        "fused_ce_bwd_dh_kernel<bf16>": (
            "_ZN44_GLOBAL__N__3a0583f4_11_fused_ce_cu_935e5b8622fused_ce_bwd_dh_kernel"
            "I13__nv_bfloat16EEvPKT_S4_PKiPKfS8_S8_PfPS1_iii",
            "_ZN44_GLOBAL__N__3a0583f4_11_fused_ce_cu_935e5b8622fused_ce_bwd_dh_kernel"
            "IfEEvPKT_S3_PKiPKfS7_S7_PfP13__nv_bfloat16iii",
        ),
        "flash_bwd_dq_kernel<64, bf16>": (
            "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64E13__nv_bfloat16EEvPKT0_",
            "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64EfEEvPKT0_",
        ),
        "fused_ce_bwd_dw_kernel<bf16>": (
            "_ZN44_GLOBAL__N__3a0583f4_11_fused_ce_cu_935e5b8622fused_ce_bwd_dw_kernel"
            "I13__nv_bfloat16EEvPKT_S4_PKiPKfS8_S8_Pfiii",
            "_ZN44_GLOBAL__N__3a0583f4_11_fused_ce_cu_935e5b8622fused_ce_bwd_dw_kernel"
            "IfEEvPKT_S3_PKiPKfS7_S7_Pfiii",
        ),
    }
    for label, (bf16_name, f32_name) in mangled.items():
        assert instances[label] in bf16_name
        assert instances[label] not in f32_name

    fwd = "_ZN12_GLOBAL__N_116flash_fwd_kernelILi64E13__nv_bfloat16EEvPKT0_"
    dq = "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64EfEEvPKT0_"
    sass = "\n".join([
        f"\tFunction : {fwd}",
        "        /*0100*/                   LDSM.16.M88.4 R4, [R2] ;",
        "        /*0110*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;",
        "        /*0120*/                   HMMA.16816.F32.BF16 R16, R4, R14, R16 ;",
        f"\tFunction : {dq}",
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;",
    ])
    assert chip_smoke.sass_mma_counts(sass) == {fwd: 2, dq: 0}
    report = "\n".join([
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        "ptxas info    : Function properties for " + fwd,
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 167 registers, used 1 barriers",
    ])
    assert chip_smoke.ptxas_resources(report) == {
        fwd: "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 167 registers, used 1 barriers"
    }
