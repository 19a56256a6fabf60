"""The rounding points of the bf16 tensor-core dW kernel, rehearsed on the CPU.

The bf16 instance of the fused lm-head CE's dW kernel
(``csrc/fused_ce.cu``, ``fused_ce_bwd_dw_kernel<bf16>``) runs both of its
products on the tensor cores: the logits h . W^T from bf16 operands
summed in f32 (each 64-column chunk of d from zero, then added in
order), and dW = dlogit^T h with bf16 operands. dlogit itself is formed
in f32, so before the second product it must become bf16; the kernel
keeps about 16 bits of it as two bf16 terms, hi = bf16(x) and
lo = bf16(x - hi), and sums hi^T h + lo^T h in f32 per 512-token tile,
adding each tile's sum to dW in token order.

``_kernel_dw`` below repeats that arithmetic in plain torch. The tests
hold it against the f32 plain version (``fused_ce_bwd_reference``) with
the limit ``chip_smoke.py`` holds the kernel to on the card (CE_DW_RTOL:
max |error| within 1e-4 of the largest |dW|), and show why the split is
there: one bf16 rounding of dlogit lands above that limit. Inputs follow
the smoke test's statistics (h ~ N(0, 1), W ~ N(0, 49/d), labels uniform,
a random cotangent), made from a numpy seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from llmtrain_tpu_torch.ops import fused_ce as fc

CE_DW_RTOL = 1e-4
TOKEN_TILE = 512  # tokens per f32 sum added into dW
D_CHUNK = 64  # d columns per tensor-core sum of the logits
# (N, d, V, z_loss): N ragged against the token tile and V against the
# kernel's 64 vocab rows in the last case, d not a multiple of D_CHUNK.
CASES = {
    "4096x256x2048": (4096, 256, 2048, 0.0),
    "8192x768x1024 z-loss": (8192, 768, 1024, 1e-3),
    "ragged 1000x96x1500": (1000, 96, 1500, 1e-3),
}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).float()


def _inputs(n: int, d: int, v: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((7.0 / np.sqrt(d) * rng.standard_normal((v, d))).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return h, w.to(torch.bfloat16), labels, g


def _kernel_dw(h, w, labels, lse, g_lse, g, *, split: bool = True) -> torch.Tensor:
    """The dW kernel's arithmetic: per 512-token tile, the logits from
    64-column chunks of d added in f32, dlogit = exp(logit - lse) * g_lse -
    onehot * g in f32, rounded to hi + lo (or, with ``split=False``, to hi
    alone), and hi^T h + lo^T h summed in f32 and added to dW in order."""
    n, d = h.shape
    v = w.shape[0]
    hf, wf = h.float(), w.float()
    dw = torch.zeros((v, d), dtype=torch.float32)
    cols = torch.arange(v)
    for t0 in range(0, n, TOKEN_TILE):
        h_t = hf[t0 : t0 + TOKEN_TILE]
        logits = torch.zeros((h_t.shape[0], v), dtype=torch.float32)
        for c0 in range(0, d, D_CHUNK):
            logits = logits + h_t[:, c0 : c0 + D_CHUNK] @ wf[:, c0 : c0 + D_CHUNK].T
        hit = cols[None, :] == labels[t0 : t0 + TOKEN_TILE, None].long()
        dlogit = torch.exp(logits - lse[t0 : t0 + TOKEN_TILE, None]) * g_lse[
            t0 : t0 + TOKEN_TILE, None
        ] - torch.where(hit, g[t0 : t0 + TOKEN_TILE, None], torch.zeros(()))
        hi = _bf16(dlogit)
        tile_sum = hi.T @ h_t
        if split:
            tile_sum = tile_sum + _bf16(dlogit - hi).T @ h_t
        dw = dw + tile_sum
    return dw


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _problem(case: str):
    n, d, v, z_loss = CASES[case]
    h, w, labels, g = _inputs(n, d, v)
    lse, _ = fc.fused_ce_fwd_reference(h, w, labels)
    g_lse = fc.g_lse_from(g, lse, z_loss)
    ref = fc.fused_ce_bwd_reference(h, w, labels, lse, g_lse, g)[1]
    return h, w, labels, lse, g_lse, g, ref


@pytest.mark.parametrize("case", list(CASES))
def test_split_dlogit_keeps_dw_within_the_limit(case: str) -> None:
    h, w, labels, lse, g_lse, g, ref = _problem(case)
    err = _rel(_kernel_dw(h, w, labels, lse, g_lse, g), ref)
    assert 0.0 < err <= CE_DW_RTOL


@pytest.mark.parametrize("case", list(CASES))
def test_one_bf16_rounding_of_dlogit_misses_the_limit(case: str) -> None:
    h, w, labels, lse, g_lse, g, ref = _problem(case)
    assert _rel(_kernel_dw(h, w, labels, lse, g_lse, g, split=False), ref) > CE_DW_RTOL
