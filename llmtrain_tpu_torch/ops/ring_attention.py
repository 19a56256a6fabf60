"""Ring attention: exact causal attention over the mesh's ``sequence``
axis (port of ``llmtrain_tpu/ops/ring_attention.py``; plain PyTorch, as
JAX's is plain XLA).

Each rank of the sequence group holds a (B, T/n, H, D) shard of q, k and
v, contiguous along the sequence in group order. The K/V shard (and its
mask shard) visits every rank in turn, passed on by point-to-point ops
(``batch_isend_irecv``) where JAX uses ``ppermute``; each rank folds its
queries' online softmax over the visiting block (ops/blockwise_attention
``chunk_scan``) and merges it into its running max and sum, as JAX does.

torch's autograd does not differentiate through send and recv, so the
ring is one ``torch.autograd.Function`` (:class:`_Ring`) whose backward
runs a ring of its own: every rank recomputes its queries' probabilities
against each visiting block from the saved row max and sum, adds to its
dQ, and adds that block's dK and dV to accumulators that travel with the
K/V, so after a full turn each shard's dK/dV is back on the rank that
owns it, summed over every query that saw it.

:func:`route_or_blockwise` is JAX's routing: the sharded path when the
active mesh has a sequence axis larger than one and the shapes divide,
else single-device blockwise attention, with JAX's warning when a real
batch loses sequence parallelism.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import torch

from .blockwise_attention import block_grads, blockwise_attention, chunk_scan

logger = logging.getLogger("llmtrain")


def _rotate(tensors: list[torch.Tensor], ranks: list[int], index: int,
            group: Any) -> list[torch.Tensor]:
    """Send each tensor to the next rank of the ring and receive the
    previous rank's (one batch of point-to-point ops)."""
    import torch.distributed as dist

    from ..distributed import collective_errors

    n = len(ranks)
    nxt, prv = ranks[(index + 1) % n], ranks[(index - 1) % n]
    received = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, received):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    with collective_errors():
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return received


def merge_partials(acc, row_max, row_sum, acc2, max2, sum2):
    """JAX's merge of a visiting block's partials into the running ones."""
    new_max = torch.maximum(row_max, max2)
    c1 = torch.exp(row_max - new_max)
    c2 = torch.exp(max2 - new_max)
    return (acc * c1[..., None] + acc2 * c2[..., None], new_max,
            row_sum * c1 + sum2 * c2)


def _forward_turns(q, k, v, key_mask, index: int, n: int, causal: bool, chunk: int):
    """Rank ``index``'s ring forward over ``n`` ranks, as a generator: at
    each turn it yields the tensors it passes on and is sent the previous
    rank's; it returns (out, row max, row sum)."""
    b, t_local, h, d = q.shape
    acc = torch.zeros((b, t_local, h, d), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, t_local, h), -1e30, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, t_local, h), dtype=torch.float32, device=q.device)
    k_cur, v_cur, m_cur = k, v, key_mask
    for step in range(n):
        # After ``step`` turns this rank holds the shard that started on
        # rank index - step; its offset drives the causal mask.
        kv_offset = ((index - step) % n) * t_local
        part = chunk_scan(q, k_cur, v_cur, q_offset=index * t_local, kv_offset=kv_offset,
                          causal=causal, kv_chunk=chunk, key_mask=m_cur,
                          # The unrotated mask: this shard's queries'
                          # segment ids.
                          query_mask=key_mask)
        acc, row_max, row_sum = merge_partials(acc, row_max, row_sum, *part)
        if step < n - 1:
            moved = yield [k_cur, v_cur] + ([m_cur] if m_cur is not None else [])
            k_cur, v_cur = moved[0], moved[1]
            m_cur = moved[2] if m_cur is not None else None
    return (acc / row_sum[..., None]).to(q.dtype), row_max, row_sum


def _backward_turns(q, k, v, key_mask, dout, out, row_max, row_sum, index: int, n: int,
                    causal: bool, chunk: int):
    """Rank ``index``'s ring backward, a generator as :func:`_forward_turns`:
    it returns (dq, dk, dv) in f32, dk and dv those of its own shard."""
    t_local = q.shape[1]
    delta = (dout.float() * out.float()).sum(dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur, m_cur = k, v, key_mask
    dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for step in range(n):
        kv_offset = ((index - step) % n) * t_local
        g_q, g_k, g_v = block_grads(q, k_cur, v_cur, dout, delta, row_max, row_sum,
                                    q_offset=index * t_local, kv_offset=kv_offset,
                                    causal=causal, kv_chunk=chunk, key_mask=m_cur,
                                    query_mask=key_mask)
        dq += g_q
        dk_cur = dk_cur + g_k
        dv_cur = dv_cur + g_v
        # The gradients travel a full turn, back to the shard's owner;
        # the K/V stop one hop short (nothing reads them after).
        if step < n - 1:
            moved = yield ([k_cur, v_cur, dk_cur, dv_cur]
                           + ([m_cur] if m_cur is not None else []))
            k_cur, v_cur, dk_cur, dv_cur = moved[:4]
            m_cur = moved[4] if m_cur is not None else None
        else:
            dk_cur, dv_cur = yield [dk_cur, dv_cur]
    return dq, dk_cur, dv_cur


def _drive(turns, rotate: Callable) -> Any:
    """Run one rank's ring generator to its end, each turn's tensors
    passed on by ``rotate``; its result."""
    try:
        sent = next(turns)
        while True:
            sent = turns.send(rotate(sent))
    except StopIteration as done:
        return done.value


def _lockstep(turns: list) -> list:
    """The ring generators of every rank run in step in one process: at
    each turn rank i is sent what rank i - 1 passed on. Their results."""
    n = len(turns)
    results: list[Any] = [None] * n

    def advance(i: int, value: Any) -> Any:
        try:
            return next(turns[i]) if value is None else turns[i].send(value)
        except StopIteration as done:
            results[i] = done.value
            return None

    sent = [advance(i, None) for i in range(n)]
    while any(s is not None for s in sent):
        sent = [advance(i, sent[(i - 1) % n]) for i in range(n)]
    return results


def _chunk(kv_chunk: int, t_local: int) -> int:
    chunk = min(kv_chunk, t_local)
    return chunk if t_local % chunk == 0 else t_local


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, group, ranks, index, causal, kv_chunk):
        chunk = _chunk(kv_chunk, q.shape[1])
        out, row_max, row_sum = _drive(
            _forward_turns(q, k, v, key_mask, index, len(ranks), causal, chunk),
            lambda tensors: _rotate(tensors, ranks, index, group))
        ctx.save_for_backward(q, k, v, key_mask, out, row_max, row_sum)
        ctx.args = (group, ranks, index, causal, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, row_max, row_sum = ctx.saved_tensors
        group, ranks, index, causal, chunk = ctx.args
        dq, dk, dv = _drive(
            _backward_turns(q, k, v, key_mask, dout, out, row_max, row_sum, index, len(ranks),
                            causal, chunk),
            lambda tensors: _rotate(tensors, ranks, index, group))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def ring_turns_on_one_device(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             dout: torch.Tensor, shards: int, *, causal: bool = True,
                             kv_chunk: int = 512) -> tuple[torch.Tensor, ...]:
    """The ring's own turns for ``shards`` shards of a whole (B, T, H, D)
    sequence, each shard a rank, run in lockstep in one process on one
    device: the forward, then the backward of ``dout``. Returns the whole
    (out, dq, dk, dv): the ring's arithmetic, checkable against plain
    attention where one device stands for the sequence group."""
    t_local = q.shape[1] // shards
    chunk = _chunk(kv_chunk, t_local)

    def part(x: torch.Tensor, i: int) -> torch.Tensor:
        return x[:, i * t_local:(i + 1) * t_local]

    fwd = _lockstep([_forward_turns(part(q, i), part(k, i), part(v, i), None, i, shards,
                                    causal, chunk) for i in range(shards)])
    bwd = _lockstep([_backward_turns(part(q, i), part(k, i), part(v, i), None, part(dout, i),
                                     *fwd[i], i, shards, causal, chunk)
                     for i in range(shards)])
    out = torch.cat([f[0] for f in fwd], dim=1)
    return (out, *(torch.cat([g[j] for g in bwd], dim=1) for j in range(3)))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: torch.Tensor | None = None, *, mesh: Any = None,
                   causal: bool = True, kv_chunk: int = 512) -> torch.Tensor:
    """Local-shard ring attention over the mesh's sequence group: q/k/v
    (B, T_local, H|Hkv, D) shards, contiguous along the sequence in group
    order; ``key_mask`` the (B, T_local) mask shard (nonzero attends,
    segment semantics), which rotates with its K/V. Returns this rank's
    (B, T_local, H, D) output shard."""
    from ..distributed import active_mesh

    mesh = mesh or active_mesh()
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32)
    return _Ring.apply(q, k, v, key_mask, mesh.group("sequence"),
                       mesh.group_ranks("sequence"), mesh.index("sequence"), causal,
                       int(kv_chunk))


def min_widen_factor(group: int, kv_heads: int, divisor: int) -> int | None:
    """The smallest exact K/V replication factor (a divisor of ``group``)
    that makes ``kv_heads * w`` divide ``divisor``; None when none does."""
    return next((w for w in range(1, group + 1)
                 if group % w == 0 and (kv_heads * w) % divisor == 0), None)


def gathered_attention(fn: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       key_mask: torch.Tensor | None, mesh: Any) -> torch.Tensor:
    """``fn(q, k, v, key_mask)`` over the whole sequence on every rank of
    the sequence group, this rank keeping its rows: q/k/v and the mask
    all-gathered along the length (their gradients reduce-scattered
    back), as GSPMD gathers around an attention it cannot shard."""
    from ..parallel.collectives import gather_dim, gather_rs, slice_dim

    group = mesh.group("sequence")
    qf, kf, vf = (gather_rs(t, 1, group) for t in (q, k, v))
    mask = None if key_mask is None else gather_dim(key_mask, 1, group)
    return slice_dim(fn(qf, kf, vf, mask), 1, group)


def route_or_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                       scheme: str, sharded_fn: Callable, extra_predicate: Callable | None = None,
                       key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """JAX's route-or-fallback policy on this rank's shards: under an
    active mesh with a sequence axis larger than one, ``sharded_fn(q, k,
    v, mesh, causal=..., key_mask=...)`` when ``extra_predicate(mesh, q)``
    holds (or there is none), else blockwise attention over the gathered
    sequence (:func:`gathered_attention`) with JAX's warning for a real
    batch; without a sequence axis, blockwise attention. The mask keeps
    segment semantics on every path."""
    from ..distributed import active_mesh

    mesh = active_mesh()
    if mesh is not None and mesh.sizes["sequence"] > 1:
        if extra_predicate is None or extra_predicate(mesh, q):
            return sharded_fn(q, k, v, mesh, causal=causal, key_mask=key_mask)
        if q.shape[0] > 1:
            logger.warning(
                "%s attention falling back to blockwise over the gathered sequence: "
                "local shape (B=%d, T=%d, H=%d, Hkv=%d) vs mesh shards (sequence %d, "
                "heads %d) — sequence parallelism is DISABLED for this computation",
                scheme, q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                mesh.size("sequence"), mesh.size("tensor"),
            )
        return gathered_attention(
            lambda a, b, c, m: blockwise_attention(a, b, c, causal=causal, key_mask=m,
                                                   query_mask=m),
            q, k, v, key_mask, mesh)
    return blockwise_attention(q, k, v, causal=causal, key_mask=key_mask, query_mask=key_mask)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Any, *,
                           causal: bool = True,
                           key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Ring attention on this rank's shards (JAX's shard_map wrapper; the
    port's K/V heads are already the rank's own, which the plan makes
    divide the tensor axis, so no widening is needed here)."""
    return ring_attention(q, k, v, key_mask, mesh=mesh, causal=causal)


def ring_or_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                      key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Ring attention when the active mesh shards the sequence; blockwise
    otherwise (the same math, no ring)."""
    return route_or_blockwise(q, k, v, causal=causal, scheme="ring",
                              sharded_fn=ring_attention_sharded, key_mask=key_mask)


__all__ = [
    "gathered_attention",
    "merge_partials",
    "min_widen_factor",
    "ring_attention",
    "ring_attention_sharded",
    "ring_or_blockwise",
    "ring_turns_on_one_device",
    "route_or_blockwise",
]
