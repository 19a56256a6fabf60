"""The order of arithmetic of the CUDA LayerNorm backward, rehearsed on the CPU.

The backward kernel (``csrc/fused_norm_bwd.cu``) cannot run here, so
``_kernel_bwd`` below repeats its arithmetic in plain torch f32:

* a warp owns a row; lane l sums dxhat and dxhat * xhat over its own
  columns in order (register path: 16-byte vector j of lane l holds
  columns (32 j + l) * per_vector + e; general path: columns l, l + 32,
  ...), then the 32 lane sums meet in a ``__shfl_xor_sync`` butterfly
  (offsets 16, 8, 4, 2, 1); m1 and m2 are those sums over d;
* ds = rstd * ((dxhat - m1) - xhat * m2), rounded to the dtype; with the
  residual's gradient gs, dx = round(float(round(ds)) + float(gs));
* dscale/dbias: per-warp sums over the warp's rows in order (block c owns
  rows [c * rows, (c + 1) * rows) of ``_bwd_grid``, warp w rows w, w + 8,
  ...), the eight warp sums added in warp order into the block's partial,
  the partials added in block order within each group of ``group``
  blocks, and the group sums in group order (0 + a single group's sum is
  that sum, so one group is the plain block-order sum).

The tests hold that model to the plain version and to JAX's
``fused_layer_norm`` / ``fused_add_layer_norm`` vjp in interpret mode,
a ragged row count and several blocks included: dx with the tolerance of
``tests/test_torch_fused_norm.py`` (f32 atol/rtol 1e-5), dscale/dbias,
which differ in summation order only, within 1e-5 of their largest
magnitude; show that the fused dx keeps the two
roundings of ``(ds + gs).to(bfloat16)`` (one rounding differs, a
control); that ``_bwd_grid`` gives every row to exactly one warp; and
that the plain version without gs is what it was. Inputs come from numpy
seeds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.ops.fused_norm import fused_add_layer_norm as jax_add_ln
from llmtrain_tpu.ops.fused_norm import fused_layer_norm as jax_ln
from llmtrain_tpu_torch.ops import fused_norm as fn

ATOL = RTOL = 1e-5
PARAM_RTOL = 1e-5
JAX_BLOCK_T = 64
H100_SMS = 132


def _lane_columns(d: int, per_vector: int, general: bool) -> torch.Tensor:
    """(32, K): the columns lane l sums, in its order; -1 where masked."""
    if general:
        cols = torch.arange(32)[:, None] + 32 * torch.arange(-(-d // 32))[None, :]
    else:
        nvec = d // per_vector
        v = torch.arange(32)[:, None] + 32 * torch.arange(-(-nvec // 32))[None, :]
        cols = (v[:, :, None] * per_vector + torch.arange(per_vector)).reshape(32, -1)
        cols = torch.where(v.repeat_interleave(per_vector, 1) < nvec, cols, -1)
    return torch.where(cols < d, cols, -1)


def _warp_sums(values: torch.Tensor, lane_cols: torch.Tensor) -> torch.Tensor:
    """Per row: each lane's sum over its columns in order, then the
    butterfly over the 32 lanes."""
    acc = torch.zeros(values.shape[0], 32)
    for k in range(lane_cols.shape[1]):
        c = lane_cols[:, k]
        acc = torch.where(c >= 0, acc + values[:, c.clamp_min(0)], acc)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    return acc[:, 0]


def _kernel_bwd(s, scale, mean, rstd, gy, gs=None, *, sm_count, single_rounding=False):
    """The kernel's arithmetic on (n, d) operands: ``(ds or dx, dscale,
    dbias)``. ``single_rounding`` (a control) rounds ds + gs once."""
    n, d = s.shape
    per_vector = 16 // s.element_size()
    general = not fn._bwd_takes_register_path(d, s.dtype, s, gy)
    lane_cols = _lane_columns(d, per_vector, general)
    sf, gf = s.float(), gy.float()
    xhat = (sf - mean[:, None]) * rstd[:, None]
    dxhat = gf * scale
    m1 = _warp_sums(dxhat, lane_cols)[:, None] / d
    m2 = _warp_sums(dxhat * xhat, lane_cols)[:, None] / d
    ds = rstd[:, None] * ((dxhat - m1) - xhat * m2)
    if gs is not None:
        ds = ds + gs.float() if single_rounding else ds.to(s.dtype).float() + gs.float()
    ctas, rows, group = fn._bwd_grid(n, d, sm_count)
    partials = []
    for c in range(ctas):
        partial = None
        for w in range(fn.BWD_WARPS):
            acc = torch.zeros(2 * d)
            for r in range(c * rows + w, min(n, (c + 1) * rows), fn.BWD_WARPS):
                acc = acc + torch.cat([gf[r] * xhat[r], gf[r]])
            partial = acc if partial is None else partial + acc
        partials.append(partial)
    total = torch.zeros(2 * d)
    for g0 in range(0, ctas, group):
        group_sum = torch.zeros(2 * d)
        for partial in partials[g0 : g0 + group]:
            group_sum = group_sum + partial
        total = total + group_sum
    return ds.to(s.dtype), total[:d], total[d:]


def _inputs(n: int, d: int, seed: int, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 2 + 0.5).astype(np.float32)
    res = rng.standard_normal((n, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(d)).astype(np.float32)
    gy = rng.standard_normal((n, d)).astype(np.float32)
    gs = rng.standard_normal((n, d)).astype(np.float32)
    tx, tr, tg, tgs = (torch.from_numpy(a).to(dtype) for a in (x, res, gy, gs))
    return x, res, scale, bias, gy, gs, (tx, tr, torch.from_numpy(scale),
                                         torch.from_numpy(bias), tg, tgs)


def _close(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL, rtol=RTOL)


def _close_sums(ours: torch.Tensor, theirs) -> None:
    """dscale/dbias: sums over up to 2011 rows in another order, held
    within PARAM_RTOL of the largest magnitude (an element near zero
    after cancellation keeps the rounding of the large partial sums)."""
    theirs = np.asarray(theirs)
    assert np.abs(ours.numpy() - theirs).max() <= PARAM_RTOL * np.abs(theirs).max()


# (n, d, SM count): ragged row counts, several blocks in one or more
# groups, and the general path (d not a multiple of 4 f32 values, and d
# above 1024) with blocks.
GRID_CASES = {
    "ragged 1003x256, 4 blocks": (1003, 256, 4),
    "ragged 605x96, 3 blocks": (605, 96, 3),
    "ragged 2011x64, 6 blocks in 2 groups": (2011, 64, 6),
    "general 130x50": (130, 50, 2),
    "general 100x1030, 4 blocks": (100, 1030, 4),
}


@pytest.mark.parametrize("residual", [False, True], ids=["ln", "add_ln"])
@pytest.mark.parametrize("case", list(GRID_CASES), ids=list(GRID_CASES))
def test_kernel_order_matches_plain_and_pallas(case: str, residual: bool) -> None:
    n, d, sm_count = GRID_CASES[case]
    x, res, scale, bias, gy, gs, (tx, tr, tscale, tbias, tg, tgs) = _inputs(n, d, seed=n + d)
    if residual:
        (_, _), vjp = jax.vjp(lambda a, r, sc, b: jax_add_ln(a, r, sc, b, 1e-6, JAX_BLOCK_T, True),
                              jnp.asarray(x), jnp.asarray(res), jnp.asarray(scale),
                              jnp.asarray(bias))
        jdx, _, jdscale, jdbias = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    else:
        _, vjp = jax.vjp(lambda a, sc, b: jax_ln(a, sc, b, 1e-6, JAX_BLOCK_T, True),
                         jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        jdx, jdscale, jdbias = vjp(jnp.asarray(gy))
    _, s, mean, rstd = fn.fused_norm_fwd_reference(tx, tr if residual else None, tscale, tbias)
    g_res = tgs if residual else None
    kernel = _kernel_bwd(s, tscale, mean, rstd, tg, g_res, sm_count=sm_count)
    plain = fn.fused_norm_bwd_reference(s, tscale, mean, rstd, tg, g_res)
    _close(kernel[0], plain[0])
    _close(kernel[0], jdx)
    for ours, theirs, pallas in zip(kernel[1:], plain[1:], (jdscale, jdbias)):
        _close_sums(ours, theirs)
        _close_sums(ours, pallas)


def test_residual_gradient_takes_two_roundings() -> None:
    """bf16: the fused dx is (ds + gs).to(bfloat16) bit for bit, in the
    plain version and in the kernel's arithmetic; one rounding of the f32
    sum differs in many elements."""
    *_, (tx, _, tscale, tbias, tg, tgs) = _inputs(2048, 768, seed=7, dtype=torch.bfloat16)
    _, s, mean, rstd = fn.fused_norm_fwd_reference(tx, None, tscale, tbias)
    ds = fn.fused_norm_bwd_reference(s, tscale, mean, rstd, tg)[0]
    dx = fn.fused_norm_bwd_reference(s, tscale, mean, rstd, tg, tgs)[0]
    assert torch.equal(dx, (ds + tgs).to(torch.bfloat16))
    k_ds = _kernel_bwd(s, tscale, mean, rstd, tg, sm_count=H100_SMS)[0]
    k_dx = _kernel_bwd(s, tscale, mean, rstd, tg, tgs, sm_count=H100_SMS)[0]
    assert torch.equal(k_dx, (k_ds + tgs).to(torch.bfloat16))
    once = _kernel_bwd(s, tscale, mean, rstd, tg, tgs, sm_count=H100_SMS, single_rounding=True)[0]
    assert (once != k_dx).float().mean().item() > 0.1


@pytest.mark.parametrize("d", [32, 100, 768, 2048])
@pytest.mark.parametrize("n", [1, 31, 32731, 32768])
def test_bwd_grid_gives_every_row_to_one_warp(n: int, d: int) -> None:
    ctas, rows, group = fn._bwd_grid(n, d, H100_SMS)
    assert 1 <= ctas <= H100_SMS * fn.BWD_CTAS_PER_SM
    assert (ctas - 1) * rows < n <= ctas * rows  # every block owns a row
    n_groups = -(-ctas // group)
    assert (n_groups - 1) * group < ctas and n_groups + 1 <= fn.BWD_COUNTERS
    assert group * group >= ctas > (group - 1) * (group - 1)
    seen = np.zeros(n, dtype=np.int64)
    for c in range(ctas):
        for w in range(fn.BWD_WARPS):
            seen[np.arange(c * rows + w, min(n, (c + 1) * rows), fn.BWD_WARPS)] += 1
    assert (seen == 1).all()
    if n * d >= H100_SMS * fn.BWD_MIN_CTA_ELEMENTS:
        assert ctas == H100_SMS  # a large input fills every SM


def test_plain_version_without_gs_is_unchanged() -> None:
    """gs=None computes what the plain version computed before it had gs."""
    for dtype in (torch.float32, torch.bfloat16):
        *_, (tx, _, tscale, tbias, tg, _) = _inputs(37, 48, seed=3, dtype=dtype)
        _, s, mean, rstd = fn.fused_norm_fwd_reference(tx, None, tscale, tbias)
        sf, gyf = s.float(), tg.float()
        xhat = (sf - mean[:, None]) * rstd[:, None]
        dxhat = gyf * tscale
        m1 = dxhat.mean(dim=1, keepdim=True)
        m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
        before = ((rstd[:, None] * (dxhat - m1 - xhat * m2)).to(dtype), (gyf * xhat).sum(dim=0),
                  gyf.sum(dim=0))
        now = fn.fused_norm_bwd_reference(s, tscale, mean, rstd, tg, None)
        assert all(torch.equal(a, b) for a, b in zip(now, before))


def test_register_path_rule() -> None:
    """Whole 16-byte vectors up to 1024 wide and aligned operands take the
    register path; anything else the general one."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert fn._bwd_takes_register_path(768, bf16)
    assert fn._bwd_takes_register_path(1024, bf16)
    assert not fn._bwd_takes_register_path(100, bf16)
    assert fn._bwd_takes_register_path(100, f32)
    assert not fn._bwd_takes_register_path(1032, f32)
    flat = torch.zeros(4 * 64 + 8, dtype=bf16)
    assert not fn._bwd_takes_register_path(64, bf16, flat[1:257])
    assert fn._bwd_takes_register_path(64, bf16, flat[8:264])


def test_add_layer_norm_backward_hands_gs_to_the_kernel(monkeypatch) -> None:
    """``fused_add_layer_norm``'s backward makes one call with gs, and its
    first output is the input gradient as returned: no separate add."""
    *_, (tx, tr, tscale, tbias, tg, tgs) = _inputs(6, 32, seed=4)
    calls = []

    def spy(s, scale, mean, rstd, gy, gs=None):
        calls.append(gs)
        return fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy, gs)

    monkeypatch.setattr(fn, "fused_norm_bwd", spy)
    x, r = tx.clone().requires_grad_(True), tr.clone().requires_grad_(True)
    y, s = fn.fused_add_layer_norm(x, r, tscale, tbias)
    torch.autograd.backward((y, s), (tg, tgs))
    assert len(calls) == 1 and torch.equal(calls[0], tgs)
    _, s_, mean, rstd = fn.fused_norm_fwd_reference(tx, tr, tscale, tbias)
    want = fn.fused_norm_bwd_reference(s_, tscale, mean, rstd, tg, tgs)[0]
    assert torch.equal(x.grad, want) and torch.equal(r.grad, want)
