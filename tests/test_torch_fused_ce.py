"""The port's fused lm-head cross-entropy against the JAX package's.

The same numpy inputs (seeded) go through JAX's ``fused_ce_per_token``
with the Pallas kernels in interpret mode, under one
``jax.value_and_grad`` per case, and through the port's
``fused_ce_per_token``, whose wrappers run the kernels' plain versions
for CPU tensors. Bands (ROADMAP.md): loss atol 2e-5; gradients atol
1e-5, rtol 1e-4, in f32 (summation order only). Cases: V ragged against
block_v, N ragged against block_t, z_loss 0 and 1e-3, the masked
components with zero gradient on masked tokens, blocks larger than the
problem, f32 operands, and bf16 hidden with an f32 W (dW in f32).
Problems stay tiny: the interpreter runs Python over every grid step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.ops.fused_ce import fused_ce_components as jax_fused_ce_components
from llmtrain_tpu.ops.fused_ce import fused_ce_per_token as jax_fused_ce_per_token
from llmtrain_tpu_torch.ops import fused_ce as fc

LOSS_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _problem(seed: int, b: int, t: int, d: int, v: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "h": rng.normal(0.0, 1.0, (b, t, d)).astype(np.float32),
        "w": (rng.normal(0.0, 0.2, (v, d))).astype(np.float32),
        "labels": rng.integers(0, v, (b, t)).astype(np.int32),
        "g": rng.normal(0.0, 1.0, (b, t)).astype(np.float32),
    }


def _jax_value_and_grad(p, block_t, block_v, z_loss, h_dtype=jnp.float32):
    labels, g = jnp.asarray(p["labels"]), jnp.asarray(p["g"])

    def loss(h, w):
        per_token = jax_fused_ce_per_token(h, w, labels, block_t, block_v, None, z_loss, True)
        return jnp.sum(per_token * g), per_token

    (_, per_token), (dh, dw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(p["h"]).astype(h_dtype), jnp.asarray(p["w"])
    )
    return np.asarray(per_token), np.asarray(dh.astype(jnp.float32)), dw


def _port_value_and_grad(p, block_t, block_v, z_loss, h_dtype=torch.float32):
    h = torch.from_numpy(p["h"]).to(h_dtype).requires_grad_(True)
    w = torch.from_numpy(p["w"]).requires_grad_(True)
    per_token = fc.fused_ce_per_token(h, w, torch.from_numpy(p["labels"]), block_t, block_v,
                                      None, z_loss)
    (per_token * torch.from_numpy(p["g"])).sum().backward()
    return per_token.detach().numpy(), h.grad, w.grad


@pytest.mark.parametrize(
    "shape, block_t, block_v, z_loss",
    [
        ((2, 13, 32, 117), 8, 32, 0.0),  # V ragged against block_v, N = 26 against block_t
        ((2, 13, 32, 117), 8, 32, 1e-3),  # the same with z-loss
        ((1, 11, 64, 40), 512, 512, 1e-3),  # blocks larger than the problem
    ],
    ids=["ragged", "ragged-zloss", "blocks-larger"],
)
def test_loss_and_grads_match_jax_f32(shape, block_t, block_v, z_loss) -> None:
    p = _problem(sum(shape), *shape)
    j_loss, j_dh, j_dw = _jax_value_and_grad(p, block_t, block_v, z_loss)
    loss, dh, dw = _port_value_and_grad(p, block_t, block_v, z_loss)
    np.testing.assert_allclose(loss, j_loss, atol=LOSS_ATOL, rtol=0)
    assert dh.dtype == torch.float32 and dw.dtype == torch.float32
    np.testing.assert_allclose(dh.numpy(), j_dh, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_bf16_hidden_with_f32_w_matches_jax_and_keeps_dw_f32() -> None:
    """Operands cast to hidden's bf16 (JAX ``_prep``), dh back in bf16,
    dW in W's f32 from an f32 sum, never rounded to bf16."""
    p = _problem(3, 2, 9, 32, 70)
    j_loss, j_dh, j_dw = _jax_value_and_grad(p, 8, 32, 1e-3, h_dtype=jnp.bfloat16)
    loss, dh, dw = _port_value_and_grad(p, 8, 32, 1e-3, h_dtype=torch.bfloat16)
    assert j_dw.dtype == jnp.float32 and dw.dtype == torch.float32 and dh.dtype == torch.bfloat16
    np.testing.assert_allclose(loss, j_loss, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # dh is rounded to bf16 once on each side from f32 sums in another
    # order: within one bf16 ulp of its magnitude.
    np.testing.assert_allclose(dh.float().numpy(), j_dh, atol=2e-3, rtol=2**-7)
    assert not np.all(np.asarray(j_dw) == np.asarray(jnp.asarray(j_dw).astype(jnp.bfloat16),
                                                       np.float32))


def test_components_mask_and_masked_tokens_get_no_gradient() -> None:
    p = _problem(4, 2, 13, 32, 117)
    mask = np.array([[1] * 9 + [0] * 4, [2] * 6 + [1] * 3 + [0] * 4], np.int32)

    def jax_loss(h, w):
        ls, n = jax_fused_ce_components(h, w, jnp.asarray(p["labels"]), jnp.asarray(mask),
                                        block_t=8, block_v=32, z_loss=1e-3, interpret=True)
        return jnp.sum(ls) / jnp.sum(n), (ls, n)

    (_, (j_ls, j_n)), (j_dh, j_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                        has_aux=True)(p["h"], p["w"])
    h = torch.from_numpy(p["h"]).requires_grad_(True)
    w = torch.from_numpy(p["w"]).requires_grad_(True)
    ls, n = fc.fused_ce_components(h, w, torch.from_numpy(p["labels"]), torch.from_numpy(mask),
                                   block_t=8, block_v=32, z_loss=1e-3)
    (ls.sum() / n.sum()).backward()
    assert n.tolist() == [9.0, 9.0] and np.asarray(j_n).tolist() == [9.0, 9.0]
    np.testing.assert_allclose(ls.detach().numpy(), np.asarray(j_ls), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(j_dh), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(j_dw), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    assert torch.all(h.grad[:, 9:] == 0) and torch.any(h.grad[:, :9] != 0)


def test_plain_version_matches_dense_logits_and_padded_rows_add_nothing() -> None:
    """Kernel-level plain versions: lse and the label logit equal the dense
    (N, V) computation; a row with label -1 (JAX's padded rows) has label
    logit 0, and a zero cotangent row adds nothing to dW."""
    p = _problem(5, 1, 10, 32, 50)
    h = torch.from_numpy(p["h"][0])
    w = torch.from_numpy(p["w"])
    labels = torch.from_numpy(p["labels"][0])
    labels[3] = -1
    lse, ll = fc.fused_ce_fwd(h, w, labels, block_t=4, block_v=16)
    logits = h @ w.T
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, 1).numpy(), atol=1e-5)
    want_ll = logits.gather(1, labels.clamp_min(0).long()[:, None])[:, 0]
    want_ll[3] = 0.0
    np.testing.assert_allclose(ll.numpy(), want_ll.numpy(), atol=1e-6)
    per_token = fc.fused_ce_per_token_reference(h[None], w, labels[None], block_t=4, block_v=16,
                                                z_loss=1e-3)
    want = torch.logsumexp(logits, 1) - want_ll + 1e-3 * torch.logsumexp(logits, 1).square()
    np.testing.assert_allclose(per_token[0].numpy(), want.numpy(), atol=2e-5)
    g = torch.from_numpy(p["g"][0])
    g[5] = 0.0
    dw_all = fc.fused_ce_bwd_dw(h, w, labels, lse, g, g, block_t=4, block_v=16)
    keep = torch.arange(10) != 5
    dw_kept = fc.fused_ce_bwd_dw(h[keep], w, labels[keep], lse[keep], g[keep], g[keep],
                                 block_t=4, block_v=16)
    torch.testing.assert_close(dw_all, dw_kept, atol=1e-6, rtol=1e-5)
    dh = fc.fused_ce_bwd_dh(h, w, labels, lse, g, g, block_t=4, block_v=16)
    assert torch.all(dh[5] == 0)


def test_wrappers_take_the_plain_version_only_on_the_cpu() -> None:
    from torch_port_helpers import foreign_device_tensor

    p = _problem(6, 1, 4, 32, 20)
    h = foreign_device_tensor(tuple(p["h"][0].shape))
    w = foreign_device_tensor(tuple(p["w"].shape))
    labels = foreign_device_tensor((4,), torch.int32)
    vec = foreign_device_tensor((4,))
    for call in (lambda: fc.fused_ce_fwd(h, w, labels),
                 lambda: fc.fused_ce_bwd_dh(h, w, labels, vec, vec, vec),
                 lambda: fc.fused_ce_bwd_dw(h, w, labels, vec, vec, vec)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()
    before = (fc.fused_ce_fwd.launches, fc.fused_ce_bwd_dh.launches, fc.fused_ce_bwd_dw.launches)
    _port_value_and_grad(p, 8, 8, 0.0)
    after = (fc.fused_ce_fwd.launches, fc.fused_ce_bwd_dh.launches, fc.fused_ce_bwd_dw.launches)
    assert before == after  # the plain version launches no kernel


@pytest.mark.parametrize(
    "change, error",
    [({"d": 48}, "multiple of 32"), ({"dtype": torch.float16}, "float32 or bfloat16"),
     ({"labels": torch.int64}, "int32"), ({"w_dtype": torch.bfloat16}, "compute dtype")],
    ids=["d48", "fp16", "int64-labels", "mixed-dtypes"],
)
def test_kernel_operand_checks_refuse_what_the_kernels_do_not_take(change, error) -> None:
    d = change.get("d", 64)
    dtype = change.get("dtype", torch.float32)
    h = torch.zeros(5, d, dtype=dtype)
    w = torch.zeros(7, d, dtype=change.get("w_dtype", dtype))
    labels = torch.zeros(5, dtype=change.get("labels", torch.int32))
    with pytest.raises((ValueError, TypeError), match=error):
        fc.check_kernel_operands(h, w, labels)
