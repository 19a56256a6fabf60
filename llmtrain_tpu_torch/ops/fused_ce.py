"""Fused lm-head + cross-entropy: the hand-written CUDA kernels (forward,
dhidden, dW), their plain versions, the differentiable per-token loss the
GPT calls, and the ``loss_impl`` resolution.

Counterpart of ``llmtrain_tpu/ops/fused_ce.py``: the TPU kernels
``_forward`` (``_fwd_kernel``, pallas_call at :265) and the two of
``_bwd`` (``_bwd_dh_kernel`` at :330, ``_bwd_dw_kernel`` at :347). The
kernel source is ``csrc/fused_ce.cu``, compiled with ``nvcc`` for
``sm_90a`` on first use and called through a plain C interface
(ops/kernel_build.py). Per token, with h (N, d) and W (V, d) in the
compute dtype and f32 accumulation::

    lse       = logsumexp_v(h . W_v)          (online max/sum over vocab tiles)
    ll        = h . W_label                    (the one column that hits)
    per_token = lse - ll (+ z_loss * lse^2)
    dlogit    = exp(logit - lse) * g_lse - onehot(label) * g,
                g_lse = g * (1 + 2 * z_loss * lse)
    dh = sum_v dlogit . W_v,   dW = sum_tokens dlogit^T . h

No (N, V) tensor reaches device memory: the kernels recompute each
logits tile from h, W and lse.

* :func:`fused_ce_fwd`, :func:`fused_ce_bwd_dh` and :func:`fused_ce_bwd_dw`
  are the kernels' wrappers: a CUDA tensor goes to the kernel or raises,
  a CPU tensor goes to the plain version, any other device raises. There
  is no fallback from a kernel to its plain version, and none to
  ``chunked_ce`` (JAX degrades to it where Pallas is missing; the port
  does not). Each counts its kernel launches in ``.launches``.
* :func:`fused_ce_fwd_reference` and :func:`fused_ce_bwd_reference` are
  the plain PyTorch versions with the Pallas arithmetic: operands in the
  compute dtype, f32 accumulation, the online max/sum over ``block_v``
  vocab tiles, the label logit from the hitting column, dh summed over
  vocab tiles and dW over ``block_t`` token tiles in order. Label -1 (a
  padded row) hits no column.
* :func:`fused_ce_per_token` (a ``torch.autograd.Function``) and
  :func:`fused_ce_components` are the JAX public functions.

``block_t`` / ``block_v`` (``model.extra.fused_ce_block_t`` /
``fused_ce_block_v``) are the TPU kernels' tile sizes. They change only
the order of summation: the plain version tiles by them, the CUDA kernels
use their own 128 x 128 tiles and ignore them.
"""

from __future__ import annotations

import ctypes

import torch

from .cost import ce_costs, record

DEFAULT_BLOCK_T = 256
DEFAULT_BLOCK_V = 512
NEG_INF = -1e30  # finite, as in the Pallas kernel (fused_ce.py:57)
LOSS_IMPLS = ("dense", "chunked_ce", "fused_ce")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "fused_ce.cu"


def resolve_loss_impl(requested: str | None, *, vocab_size: int, ce_auto_vocab: int) -> str:
    """``model.extra.loss_impl`` as JAX's ``resolve_loss_impl``
    (llmtrain_tpu/ops/fused_ce.py:73) resolves it on its kernels' device:
    an explicit value wins (unknown raises); unset picks the fused
    lm-head CE at ``vocab_size >= ce_auto_vocab``, else ``dense``."""
    if requested is not None:
        if requested not in LOSS_IMPLS:
            raise ValueError(
                f"model.extra.loss_impl {requested!r} unknown; "
                f"expected one of {', '.join(LOSS_IMPLS)}"
            )
        return requested
    return "fused_ce" if vocab_size >= ce_auto_vocab else "dense"


def _check_operands(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor) -> tuple[int, int, int]:
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(
            f"h must be (N, d) and w (V, d); got {tuple(h.shape)} and {tuple(w.shape)}"
        )
    n, d = h.shape
    v = w.shape[0]
    if labels.shape != (n,):
        raise ValueError(f"labels must be (N,) = ({n},), got {tuple(labels.shape)}")
    if n < 1 or v < 1 or d < 1:
        raise ValueError(f"fused CE needs N, V, d >= 1, got N={n} V={v} d={d}")
    if h.dtype != w.dtype:
        raise TypeError(f"h and w must share the compute dtype, got {h.dtype} and {w.dtype}")
    return n, v, d


def _check_blocks(block_t: int, block_v: int) -> None:
    if block_t < 1 or block_v < 1:
        raise ValueError(f"block_t and block_v must be >= 1, got {block_t}, {block_v}")


def fused_ce_fwd_reference(
    h: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    *,
    block_t: int = DEFAULT_BLOCK_T,
    block_v: int = DEFAULT_BLOCK_V,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(lse, ll)``, (N,) f32 each.

    Each (block_t x block_v) logits tile is h . W^T of the compute-dtype
    operands accumulated in f32; the running max and sum carry across the
    vocab tiles of a token tile, and the label logit is taken from the one
    column that hits. JAX pads the ragged last tiles and masks their
    columns to -1e30; those add exp(-1e30 - m) == 0, so leaving them out
    is the same arithmetic.
    """
    n, v, _ = _check_operands(h, w, labels)
    _check_blocks(block_t, block_v)
    hf, wf = h.float(), w.float()
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    ll = torch.empty(n, dtype=torch.float32, device=h.device)
    for t0 in range(0, n, block_t):
        h_t = hf[t0 : t0 + block_t]
        lab = labels[t0 : t0 + block_t].long()
        m = torch.full((h_t.shape[0],), NEG_INF, dtype=torch.float32, device=h.device)
        s = torch.zeros_like(m)
        hit_sum = torch.zeros_like(m)
        for v0 in range(0, v, block_v):
            logits = h_t @ wf[v0 : v0 + block_v].T
            m_new = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
            m = m_new
            col = torch.arange(v0, v0 + logits.shape[1], device=h.device)
            hit = col[None, :] == lab[:, None]
            hit_sum = hit_sum + torch.where(hit, logits, torch.zeros_like(logits)).sum(dim=1)
        lse[t0 : t0 + block_t] = m + torch.log(s)
        ll[t0 : t0 + block_t] = hit_sum
    return lse, ll


def fused_ce_bwd_reference(
    h: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    lse: torch.Tensor,
    g_lse: torch.Tensor,
    g: torch.Tensor,
    *,
    block_t: int = DEFAULT_BLOCK_T,
    block_v: int = DEFAULT_BLOCK_V,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels: ``(dh, dw)``, (N, d) and
    (V, d) in f32. Each logits tile is recomputed, turned into dlogit =
    exp(logit - lse) * g_lse - onehot(label) * g, and contracted in f32:
    dh over vocab tiles in order, dW over token tiles in order (the
    orders of the Pallas grids)."""
    n, v, d = _check_operands(h, w, labels)
    _check_blocks(block_t, block_v)
    hf, wf = h.float(), w.float()
    dh = torch.zeros((n, d), dtype=torch.float32, device=h.device)
    dw = torch.zeros((v, d), dtype=torch.float32, device=h.device)
    for t0 in range(0, n, block_t):
        h_t = hf[t0 : t0 + block_t]
        lab = labels[t0 : t0 + block_t].long()
        lse_t = lse[t0 : t0 + block_t, None]
        gl_t = g_lse[t0 : t0 + block_t, None]
        g_t = g[t0 : t0 + block_t, None]
        for v0 in range(0, v, block_v):
            w_v = wf[v0 : v0 + block_v]
            logits = h_t @ w_v.T
            col = torch.arange(v0, v0 + w_v.shape[0], device=h.device)
            hit = col[None, :] == lab[:, None]
            dlogit = torch.exp(logits - lse_t) * gl_t - torch.where(
                hit, g_t, torch.zeros_like(g_t)
            )
            dh[t0 : t0 + block_t] += dlogit @ w_v
            dw[v0 : v0 + block_v] += dlogit.T @ h_t
    return dh, dw


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (ctypes
    would otherwise pass each pointer as a 32-bit int)."""
    from .kernel_build import load_library

    lib = load_library(_SOURCE)
    if lib.fused_ce_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_ce_fwd.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.fused_ce_bwd_dh.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.fused_ce_bwd_dw.argtypes = [p] * 7 + [i] * 4 + [p]
        for fn in (lib.fused_ce_fwd, lib.fused_ce_bwd_dh, lib.fused_ce_bwd_dw):
            fn.restype = ctypes.c_int
        lib.fused_ce_error_string.argtypes = [i]
        lib.fused_ce_error_string.restype = ctypes.c_char_p
    return lib


def check_kernel_operands(
    h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *vectors: torch.Tensor
) -> tuple[int, int, int]:
    """What every kernel wrapper checks before a launch: one device,
    float32 or bfloat16 operands of one dtype, int32 labels, f32 (N,)
    vectors, contiguous 16-byte-aligned tensors, and d a positive multiple
    of 32. Returns (N, V, d)."""
    n, v, d = _check_operands(h, w, labels)
    for name, x in (("w", w), ("labels", labels), *(("vector", x) for x in vectors)):
        if x.device != h.device:
            raise ValueError(f"{name} is on {x.device}, h on {h.device}")
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused CE kernels take float32 or bfloat16 h/w, got {h.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    for x in vectors:
        if x.dtype != torch.float32 or x.shape != (n,):
            raise TypeError(f"lse/g vectors must be float32 ({n},), got {x.dtype} {tuple(x.shape)}")
    if d % 32:
        raise ValueError(f"fused CE kernels take d a multiple of 32, got {d}")
    for x in (h, w, labels, *vectors):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("fused CE kernels need contiguous, 16-byte aligned operands")
    return n, v, d


def _device_kind(h: torch.Tensor) -> str:
    if h.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"fused CE runs on cuda or cpu tensors, not {h.device}")
    return h.device.type


def _count(kernel: int, h: torch.Tensor, w: torch.Tensor) -> None:
    """Record kernel ``kernel`` (0 fwd, 1 dh, 2 dW) of a ``meta`` call
    (ops/cost.py)."""
    name = ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw")[kernel]
    record(name, *ce_costs(h.shape[0], h.shape[1], w.shape[0], h.element_size())[kernel])


def _raise_on_error(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.fused_ce_error_string(rc).decode()}")


def fused_ce_fwd(
    h: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    *,
    block_t: int = DEFAULT_BLOCK_T,
    block_v: int = DEFAULT_BLOCK_V,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lse, ll)`` over h (N, d) and w (V, d) of one compute dtype and
    int32 labels (N,): the forward kernel for CUDA tensors (counted in
    ``fused_ce_fwd.launches``; the tile sizes are its own), the plain
    version for CPU tensors."""
    if _device_kind(h) == "cpu":
        return fused_ce_fwd_reference(h, w, labels, block_t=block_t, block_v=block_v)
    if _device_kind(h) == "meta":
        _count(0, h, w)
        n = h.shape[0]
        return (torch.empty(n, dtype=torch.float32, device=h.device),
                torch.empty(n, dtype=torch.float32, device=h.device))
    n, v, d = check_kernel_operands(h, w, labels)
    lib = _library()
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    ll = torch.zeros(n, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.fused_ce_fwd(h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                              ll.data_ptr(), n, v, d, _DTYPE_CODES[h.dtype], stream)
    _raise_on_error(lib, rc, "fused_ce_fwd")
    fused_ce_fwd.launches += 1
    return lse, ll


fused_ce_fwd.launches = 0


def fused_ce_bwd_dh(
    h: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    lse: torch.Tensor,
    g_lse: torch.Tensor,
    g: torch.Tensor,
    *,
    out_dtype: torch.dtype | None = None,
    block_t: int = DEFAULT_BLOCK_T,
    block_v: int = DEFAULT_BLOCK_V,
) -> torch.Tensor:
    """dhidden (N, d) in ``out_dtype`` (default h's), summed in f32: the
    dh kernel for CUDA tensors (``fused_ce_bwd_dh.launches``), the plain
    version for CPU ones."""
    out_dtype = out_dtype or h.dtype
    if _device_kind(h) == "cpu":
        return fused_ce_bwd_reference(h, w, labels, lse, g_lse, g, block_t=block_t,
                                      block_v=block_v)[0].to(out_dtype)
    if _device_kind(h) == "meta":
        _count(1, h, w)
        return torch.empty(h.shape, dtype=out_dtype, device=h.device)
    n, v, d = check_kernel_operands(h, w, labels, lse, g_lse, g)
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"the dh kernel writes float32 or bfloat16, not {out_dtype}")
    lib = _library()
    dh = torch.empty((n, d), dtype=torch.float32, device=h.device)
    dh_bf16 = torch.empty((n, d), dtype=out_dtype, device=h.device) \
        if out_dtype == torch.bfloat16 else None
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.fused_ce_bwd_dh(
            h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(), g_lse.data_ptr(),
            g.data_ptr(), dh.data_ptr(), dh_bf16.data_ptr() if dh_bf16 is not None else None,
            n, v, d, _DTYPE_CODES[h.dtype], stream,
        )
    _raise_on_error(lib, rc, "fused_ce_bwd_dh")
    fused_ce_bwd_dh.launches += 1
    return dh if dh_bf16 is None else dh_bf16


fused_ce_bwd_dh.launches = 0


def fused_ce_bwd_dw(
    h: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    lse: torch.Tensor,
    g_lse: torch.Tensor,
    g: torch.Tensor,
    *,
    block_t: int = DEFAULT_BLOCK_T,
    block_v: int = DEFAULT_BLOCK_V,
) -> torch.Tensor:
    """dW (V, d) in f32: the dW kernel for CUDA tensors
    (``fused_ce_bwd_dw.launches``), the plain version for CPU ones."""
    if _device_kind(h) == "cpu":
        return fused_ce_bwd_reference(h, w, labels, lse, g_lse, g, block_t=block_t,
                                      block_v=block_v)[1]
    if _device_kind(h) == "meta":
        _count(2, h, w)
        return torch.empty(w.shape, dtype=torch.float32, device=h.device)
    n, v, d = check_kernel_operands(h, w, labels, lse, g_lse, g)
    lib = _library()
    dw = torch.empty((v, d), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.fused_ce_bwd_dw(
            h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(), g_lse.data_ptr(),
            g.data_ptr(), dw.data_ptr(), n, v, d, _DTYPE_CODES[h.dtype], stream,
        )
    _raise_on_error(lib, rc, "fused_ce_bwd_dw")
    fused_ce_bwd_dw.launches += 1
    return dw


fused_ce_bwd_dw.launches = 0


def _prep(hidden, w_vocab, labels, compute_dtype):
    """The kernel view, as JAX's ``_prep`` (:234) makes it without the
    padding: (N, d) hidden and (V, d) W in the compute dtype (hidden's
    unless given), int32 labels (N,)."""
    n = labels.numel()
    dt = compute_dtype or hidden.dtype
    h = hidden.reshape(n, hidden.shape[-1]).to(dt).contiguous()
    w = w_vocab.to(dt).contiguous()
    return h, w, labels.reshape(n).to(torch.int32).contiguous()


def g_lse_from(g: torch.Tensor, lse: torch.Tensor, z_loss: float) -> torch.Tensor:
    """d(per_token)/d(lse): 1 for the CE term plus 2 * z_loss * lse for
    the z-loss, times the cotangent (JAX ``_bwd`` :322)."""
    return g * (1.0 + 2.0 * z_loss * lse) if z_loss > 0.0 else g


class _FusedCE(torch.autograd.Function):
    """``fused_ce_per_token``'s ``custom_vjp``: the forward saves (hidden,
    W, labels, lse) as ``_fwd`` does (:307); the backward forms g_lse and
    runs the dh and dW kernels (their plain version on the CPU). W is the
    parameter in its own dtype and is cast inside, so dW comes back in
    that dtype from an f32 sum; dh comes back in hidden's dtype."""

    @staticmethod
    def forward(ctx, hidden, w_vocab, labels, block_t, block_v, compute_dtype, z_loss):  # noqa: ANN001 — autograd API
        h, w, lab = _prep(hidden, w_vocab, labels, compute_dtype)
        lse, ll = fused_ce_fwd(h, w, lab, block_t=block_t, block_v=block_v)
        per_token = lse - ll
        if z_loss > 0.0:
            per_token = per_token + z_loss * lse.square()
        ctx.save_for_backward(hidden, w_vocab, labels, lse)
        ctx.config = (block_t, block_v, compute_dtype, z_loss)
        return per_token.reshape(labels.shape)

    @staticmethod
    def backward(ctx, grad):  # noqa: ANN001 — autograd API
        hidden, w_vocab, labels, lse = ctx.saved_tensors
        block_t, block_v, compute_dtype, z_loss = ctx.config
        h, w, lab = _prep(hidden, w_vocab, labels, compute_dtype)
        g = grad.reshape(-1).float().contiguous()
        g_lse = g_lse_from(g, lse, z_loss).contiguous()
        blocks = dict(block_t=block_t, block_v=block_v)
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = fused_ce_bwd_dh(h, w, lab, lse, g_lse, g, out_dtype=hidden.dtype, **blocks)
            dh = dh.reshape(hidden.shape)
        if ctx.needs_input_grad[1]:
            dw = fused_ce_bwd_dw(h, w, lab, lse, g_lse, g, **blocks).to(w_vocab.dtype)
        return dh, dw, None, None, None, None, None


def fused_ce_per_token(
    hidden: torch.Tensor,
    w_vocab: torch.Tensor,
    labels: torch.Tensor,
    block_t: int = DEFAULT_BLOCK_T,
    block_v: int = DEFAULT_BLOCK_V,
    compute_dtype: torch.dtype | None = None,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Per-token CE loss, f32, shape (B, T), differentiable in ``hidden``
    (B, T, d) and ``w_vocab`` (V, d) (embedding layout: the tied
    ``token_embedding.weight`` or the untied ``lm_head.weight``)."""
    _check_blocks(block_t, block_v)
    return _FusedCE.apply(hidden, w_vocab, labels, block_t, block_v, compute_dtype, z_loss)


def fused_ce_per_token_reference(
    hidden: torch.Tensor,
    w_vocab: torch.Tensor,
    labels: torch.Tensor,
    *,
    block_t: int = DEFAULT_BLOCK_T,
    block_v: int = DEFAULT_BLOCK_V,
    compute_dtype: torch.dtype | None = None,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """The plain version of :func:`fused_ce_per_token`'s forward on any
    device (its backward is :func:`fused_ce_bwd_reference`)."""
    h, w, lab = _prep(hidden, w_vocab, labels, compute_dtype)
    lse, ll = fused_ce_fwd_reference(h, w, lab, block_t=block_t, block_v=block_v)
    per_token = lse - ll
    if z_loss > 0.0:
        per_token = per_token + z_loss * lse.square()
    return per_token.reshape(labels.shape)


def masked_sums(
    per_token: torch.Tensor, attention_mask: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example ``(loss_sum, token_count)`` of shape (B,) with boolean
    mask semantics (segment ids > 1 from packing are not loss weights)."""
    if attention_mask is None:
        mask = torch.ones_like(per_token)
    else:
        mask = (attention_mask != 0).float()
    return (per_token * mask).sum(dim=-1), mask.sum(dim=-1)


def fused_ce_components(
    hidden: torch.Tensor,
    w_vocab: torch.Tensor,
    labels: torch.Tensor,
    attention_mask: torch.Tensor | None,
    *,
    block_t: int = DEFAULT_BLOCK_T,
    block_v: int = DEFAULT_BLOCK_V,
    z_loss: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example ``(loss_sum, token_count)`` of shape (B,): the
    mask-aware contract of ``masked_ce_components``, computed by the fused
    kernels (JAX ``fused_ce_components`` :371)."""
    per_token = fused_ce_per_token(hidden, w_vocab, labels, block_t, block_v, None, z_loss)
    return masked_sums(per_token, attention_mask)


__all__ = [
    "DEFAULT_BLOCK_T",
    "DEFAULT_BLOCK_V",
    "LOSS_IMPLS",
    "NEG_INF",
    "check_kernel_operands",
    "fused_ce_bwd_dh",
    "fused_ce_bwd_dw",
    "fused_ce_bwd_reference",
    "fused_ce_components",
    "fused_ce_fwd",
    "fused_ce_fwd_reference",
    "fused_ce_per_token",
    "fused_ce_per_token_reference",
    "g_lse_from",
    "masked_sums",
    "resolve_loss_impl",
]
