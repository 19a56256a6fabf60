"""The port's chunked cross-entropy against the JAX package's.

Seeded numpy inputs go through JAX's ``chunked_ce_per_token`` under
``jax.value_and_grad`` and through the port's, with a chunk that does not
divide V, z_loss 0 and 1e-3, f32 and bf16 hidden. Bands (ROADMAP.md):
loss atol 2e-5; gradients atol 1e-5, rtol 1e-4 in f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401 — caps torch at one CPU thread

from llmtrain_tpu.ops.chunked_ce import chunked_ce_components as jax_chunked_ce_components
from llmtrain_tpu.ops.chunked_ce import chunked_ce_per_token as jax_chunked_ce_per_token
from llmtrain_tpu_torch.ops.chunked_ce import chunked_ce_components, chunked_ce_per_token

LOSS_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _problem(seed: int, b: int, t: int, d: int, v: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, v, (b, t)).astype(np.int32)
    labels[0, :3] = labels[0, 3]  # repeated labels: the dW scatter-add sums them
    return {
        "h": rng.normal(0.0, 1.0, (b, t, d)).astype(np.float32),
        "w": rng.normal(0.0, 0.2, (v, d)).astype(np.float32),
        "labels": labels,
        "g": rng.normal(0.0, 1.0, (b, t)).astype(np.float32),
    }


@pytest.mark.parametrize(
    "chunk, z_loss, bf16",
    [(32, 0.0, False), (32, 1e-3, False), (500, 1e-3, False), (32, 1e-3, True)],
    ids=["ragged-chunk", "ragged-chunk-zloss", "chunk-larger-than-v", "bf16-hidden"],
)
def test_loss_and_grads_match_jax(chunk: int, z_loss: float, bf16: bool) -> None:
    p = _problem(chunk + int(bf16), 2, 11, 32, 117)
    labels, g = jnp.asarray(p["labels"]), jnp.asarray(p["g"])
    j_dtype, t_dtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)

    def loss(h, w):
        per_token = jax_chunked_ce_per_token(h, w, labels, chunk, None, z_loss)
        return jnp.sum(per_token * g), per_token

    (_, j_loss), (j_dh, j_dw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(p["h"]).astype(j_dtype), jnp.asarray(p["w"]))
    h = torch.from_numpy(p["h"]).to(t_dtype).requires_grad_(True)
    w = torch.from_numpy(p["w"]).requires_grad_(True)
    per_token = chunked_ce_per_token(h, w, torch.from_numpy(p["labels"]), chunk, None, z_loss)
    (per_token * torch.from_numpy(p["g"])).sum().backward()
    np.testing.assert_allclose(per_token.detach().numpy(), np.asarray(j_loss), atol=LOSS_ATOL,
                               rtol=0)
    assert h.grad.dtype == t_dtype and w.grad.dtype == torch.float32
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(j_dw), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    if bf16:
        # dh is rounded to bf16 once on each side from f32 sums taken in
        # another order: one bf16 ulp of its magnitude.
        np.testing.assert_allclose(h.grad.float().numpy(), np.asarray(j_dh, np.float32),
                                   atol=2e-3, rtol=2**-7)
    else:
        np.testing.assert_allclose(h.grad.numpy(), np.asarray(j_dh), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_components_mask_semantics_match_jax() -> None:
    p = _problem(9, 2, 13, 32, 117)
    mask = np.array([[1] * 9 + [0] * 4, [2] * 6 + [1] * 3 + [0] * 4], np.int32)
    j_ls, j_n = jax_chunked_ce_components(jnp.asarray(p["h"]), jnp.asarray(p["w"]),
                                          jnp.asarray(p["labels"]), jnp.asarray(mask),
                                          chunk=40, z_loss=1e-3)
    ls, n = chunked_ce_components(torch.from_numpy(p["h"]), torch.from_numpy(p["w"]),
                                  torch.from_numpy(p["labels"]), torch.from_numpy(mask),
                                  chunk=40, z_loss=1e-3)
    np.testing.assert_allclose(ls.numpy(), np.asarray(j_ls), atol=1e-4, rtol=1e-5)
    assert n.tolist() == np.asarray(j_n).tolist() == [9.0, 9.0]
    with pytest.raises(ValueError, match="chunk"):
        chunked_ce_per_token(torch.zeros(1, 2, 32), torch.zeros(3, 32),
                             torch.zeros(1, 2, dtype=torch.int32), 0)
