"""The port's fused add+LayerNorm against the Pallas TPU kernels.

On the CPU the port's wrappers run their plain versions (the Triton
kernels are held against them on the card by chip_smoke.py); here they are
held against ``fused_layer_norm`` / ``fused_add_layer_norm`` of
``llmtrain_tpu/ops/fused_norm.py`` in interpret mode, values and
gradients (``jax.vjp``), on seeded inputs. Tolerance: f32 atol/rtol 1e-5
(summation order only; dscale/dbias sum over every token, rtol 1e-5).
A ragged token count (not a multiple of the TPU's 256-token block) and a
cotangent on the returned sum are included.
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


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(d)).astype(np.float32)
    gy = rng.standard_normal(shape).astype(np.float32)
    gs = rng.standard_normal(shape).astype(np.float32)
    return x, res, scale, bias, gy, gs


def _close(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(2, 16, 32), (3, 7, 48)], ids=["tokens32", "ragged21"])
def test_layer_norm_values_and_grads_match_pallas(shape) -> None:
    x, _, scale, bias, gy, _ = _inputs(shape, seed=0)
    y, vjp = jax.vjp(lambda a, s, b: jax_ln(a, s, b, 1e-6, 8, True),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(gy))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias))
    ty = fn.fused_layer_norm(tx, ts, tb)
    ty.backward(torch.from_numpy(gy))
    _close(ty, y)
    _close(tx.grad, jdx)
    _close(ts.grad, jds)
    _close(tb.grad, jdb)


@pytest.mark.parametrize("shape", [(2, 16, 32), (3, 7, 48)], ids=["tokens32", "ragged21"])
def test_add_layer_norm_values_and_grads_match_pallas(shape) -> None:
    x, res, scale, bias, gy, gs = _inputs(shape, seed=1)
    (y, s), vjp = jax.vjp(lambda a, r, sc, b: jax_add_ln(a, r, sc, b, 1e-6, 8, True),
                          jnp.asarray(x), jnp.asarray(res), jnp.asarray(scale), jnp.asarray(bias))
    jdx, jdr, jds, jdb = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    tx, tr, ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, res, scale, bias))
    ty, tsum = fn.fused_add_layer_norm(tx, tr, ts, tb)
    torch.autograd.backward((ty, tsum), (torch.from_numpy(gy), torch.from_numpy(gs)))
    _close(ty, y)
    _close(tsum, s)
    for ours, theirs in ((tx.grad, jdx), (tr.grad, jdr), (ts.grad, jds), (tb.grad, jdb)):
        _close(ours, theirs)


def test_plain_versions_are_what_the_cpu_wrappers_run() -> None:
    x, res, scale, bias, gy, _ = _inputs((4, 24), seed=2)
    tx, tr, ts, tb, tg = (torch.from_numpy(a) for a in (x, res, scale, bias, gy))
    before = (fn.fused_norm_fwd.launches, fn.fused_norm_bwd.launches)
    got = fn.fused_norm_fwd(tx, tr, ts, tb)
    want = fn.fused_norm_fwd_reference(tx, tr, ts, tb)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    y, s, mean, rstd = got
    # Two-pass statistics in f32, as the kernel computes them.
    sf = (tx + tr).double()
    np.testing.assert_allclose(mean.numpy(), sf.mean(1).numpy(), rtol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), (1 / (sf.var(1, unbiased=False) + 1e-6).sqrt()).numpy(),
                               rtol=1e-5)
    bwd = fn.fused_norm_bwd(s, ts, mean, rstd, tg)
    assert all(torch.equal(a, b) for a, b in zip(bwd, fn.fused_norm_bwd_reference(s, ts, mean, rstd, tg)))
    after = (fn.fused_norm_fwd.launches, fn.fused_norm_bwd.launches)
    assert after == before


def test_bf16_keeps_dtypes_and_f32_statistics() -> None:
    x, res, scale, bias, _, _ = _inputs((4, 32), seed=3)
    tx, tr = torch.from_numpy(x).bfloat16(), torch.from_numpy(res).bfloat16()
    y, s, mean, rstd = fn.fused_norm_fwd(tx, tr, torch.from_numpy(scale), torch.from_numpy(bias))
    assert y.dtype == s.dtype == torch.bfloat16
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == (4,)
    torch.testing.assert_close(s, (tx.float() + tr.float()).bfloat16(), atol=0, rtol=0)


def test_non_cpu_non_cuda_tensor_raises() -> None:
    from torch_port_helpers import foreign_device_tensor

    x = foreign_device_tensor((2, 8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn.fused_norm_fwd(x, None, foreign_device_tensor((8,)), foreign_device_tensor((8,)))
