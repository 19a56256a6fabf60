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

The bf16 forward and dh kernels share that walk with the roles of tokens
and vocabulary swapped: a block owns 64 tokens and streams the vocabulary.
``_kernel_fwd`` repeats the forward's arithmetic (the same per-chunk
logits, a running max and sum per thread over its columns, merged across
the four lanes of a quad and then across the four warps) and is held to
CE_LOSS_RTOL on lse and the per-token loss. ``_kernel_dh`` repeats dh's:
dlogit rounded to bf16 once (dh is held to 2^-7, not dW's 1e-4, so the
split is not needed), dlogit . W summed in f32 per 512-column vocab tile
and added in order, the result rounded to bf16; it is held to CE_DH_RTOL,
and a control with the one-hot term dropped lands above that.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu_torch.ops import fused_ce as fc

CE_DW_RTOL = 1e-4
CE_DH_RTOL = 2**-7
CE_LOSS_RTOL = 1e-5
TOKEN_TILE = 512  # tokens per f32 sum added into dW
VOCAB_TILE = 512  # vocab columns per f32 sum added into dh
PASS = 128  # vocab columns per logits product of the forward
D_CHUNK = 64  # d columns per tensor-core sum of the logits
NEG_INF = -1e30
LOG2E = 1.4426950408889634
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


def _chunked_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h . w^T in f32, each 64-column chunk of d summed from zero and the
    chunks added in order."""
    logits = torch.zeros((h.shape[0], w.shape[0]), dtype=torch.float32)
    for c0 in range(0, h.shape[1], D_CHUNK):
        logits = logits + h[:, c0 : c0 + D_CHUNK] @ w[:, c0 : c0 + D_CHUNK].T
    return logits


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
        logits = _chunked_logits(h_t, wf)
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


def _kernel_dh(h, w, labels, lse, g_lse, g, *, one_hot: bool = True) -> torch.Tensor:
    """The dh kernel's arithmetic: per 512-column vocab tile, the logits
    from 64-column chunks of d added in f32, dlogit = exp(logit - lse) *
    g_lse - onehot * g in f32 rounded once to bf16, dlogit . W summed in f32
    and added to dh in order; dh rounded to bf16 at the end. With
    ``one_hot=False`` (a control) dlogit stays f32 and loses the one-hot."""
    hf, wf = h.float(), w.float()
    dh = torch.zeros(hf.shape, dtype=torch.float32)
    for v0 in range(0, w.shape[0], VOCAB_TILE):
        w_v = wf[v0 : v0 + VOCAB_TILE]
        logits = _chunked_logits(hf, w_v)
        dlogit = torch.exp(logits - lse[:, None]) * g_lse[:, None]
        if one_hot:
            hit = torch.arange(v0, v0 + w_v.shape[0])[None, :] == labels[:, None].long()
            dlogit = _bf16(dlogit - torch.where(hit, g[:, None], torch.zeros(())))
        dh = dh + dlogit @ w_v
    return _bf16(dh)


def _merge(m, s, m_b, s_b):
    """Two running (max, sum of exp(x - max)) pairs merged, exp as exp2."""
    mx = torch.maximum(m, m_b)
    return mx, s * torch.exp2((m - mx) * LOG2E) + s_b * torch.exp2((m_b - mx) * LOG2E)


def _kernel_fwd(h, w, labels) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic: per-chunk f32 logits, columns past
    V at -1e30; each thread keeps a running (max, sum) over its columns of
    every 128-column pass (warp ws holds columns 32 ws .. +32 of a pass,
    lane tq of a quad columns 8 nt + 2 tq + {0, 1}); the pairs are merged
    across the quad (lanes tq ^ 1, then tq ^ 2) and then over the four
    warps in order. Returns (lse, label logit)."""
    n, v = h.shape[0], w.shape[0]
    logits = _chunked_logits(h.float(), w.float())
    n_pass = -(-v // PASS)
    x = torch.full((n, n_pass * PASS), NEG_INF)
    x[:, :v] = logits
    # (N, pass, ws, nt, tq, j) -> (N, pass, ws, tq, nt * j)
    x = x.view(n, n_pass, 4, 4, 4, 2).permute(0, 1, 2, 4, 3, 5).reshape(n, n_pass, 4, 4, 8)
    m = torch.full((n, 4, 4), NEG_INF)
    s = torch.zeros((n, 4, 4))
    for p in range(n_pass):
        mx = torch.maximum(m, x[:, p].amax(dim=-1))
        s = s * torch.exp2((m - mx) * LOG2E) + torch.exp2((x[:, p] - mx[..., None]) * LOG2E).sum(-1)
        m = mx
    for off in (1, 2):
        partner = torch.arange(4) ^ off
        m, s = _merge(m, s, m[:, :, partner], s[:, :, partner])
    lse_m, lse_s = torch.full((n,), NEG_INF), torch.zeros(n)
    for ws in range(4):
        lse_m, lse_s = _merge(lse_m, lse_s, m[:, ws, 0], s[:, ws, 0])
    ll = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse_m + torch.log(lse_s), ll


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


# The file's cases plus the GPT-2 vocabulary with a few hundred tokens.
DH_CASES = {**CASES, "256x768x50257 z-loss": (256, 768, 50257, 1e-3)}


def _dh_problem(case: str):
    n, d, v, z_loss = DH_CASES[case]
    h, w, labels, g = _inputs(n, d, v)
    lse, ll = fc.fused_ce_fwd_reference(h, w, labels)
    g_lse = fc.g_lse_from(g, lse, z_loss)
    return h, w, labels, lse, ll, g_lse, g, z_loss


@pytest.mark.parametrize("case", list(DH_CASES))
def test_one_bf16_rounding_of_dlogit_keeps_dh_within_the_limit(case: str) -> None:
    h, w, labels, lse, _, g_lse, g, _ = _dh_problem(case)
    ref = fc.fused_ce_bwd_reference(h, w, labels, lse, g_lse, g)[0]
    err = _rel(_kernel_dh(h, w, labels, lse, g_lse, g), ref)
    assert 0.0 < err <= CE_DH_RTOL
    # The control, dlogit in f32 without the one-hot term, lands above it.
    assert _rel(_kernel_dh(h, w, labels, lse, g_lse, g, one_hot=False), ref) > CE_DH_RTOL


@pytest.mark.parametrize("z_loss", [0.0, 1e-3], ids=["plain", "z-loss"])
@pytest.mark.parametrize("case", list(DH_CASES))
def test_forward_running_pairs_keep_lse_and_loss_within_the_limit(case: str,
                                                                  z_loss: float) -> None:
    h, w, labels, r_lse, r_ll, _, _, _ = _dh_problem(case)
    lse, ll = _kernel_fwd(h, w, labels)
    per_token = lse - ll + z_loss * lse.square()
    r_per_token = r_lse - r_ll + z_loss * r_lse.square()
    assert _rel(lse, r_lse) <= CE_LOSS_RTOL
    assert _rel(per_token, r_per_token) <= CE_LOSS_RTOL
