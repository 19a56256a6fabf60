"""GPipe pipeline parallelism over the mesh's ``pipeline`` axis (port of
``llmtrain_tpu/parallel/pipeline.py``).

Every parameter leaf of a stage carries its layer dim leading; stage ``s``
of ``S`` holds the contiguous rows ``[s·L/S, (s+1)·L/S)`` (the logical axis
``layers`` over ``pipeline``, parallel/sharding.py). Activations are
batch-sharded over the data axes and replicated over ``pipeline``. With
``M`` microbatches the schedule runs ``v·M + S − 1`` ticks; at tick ``t``
stage ``s`` works on item ``t − s`` (round ``item // M``, microbatch
``item − round·M``, clamped as JAX clamps them) and hands its output to
stage ``s + 1`` (the last stage to stage 0, which banks it for its next
round under the interleaved schedule, ``virtual_chunks`` v > 1). The last
stage's final-round outputs are the result, which every stage then holds
(JAX's closing ``psum``, here a broadcast from the last stage).

The schedule is one forward generator and one backward generator per
stage, written once and driven by either transport:

* over the mesh (:func:`gpipe_apply`): each rank runs its own stage and
  the hops are point-to-point operations over its pipeline group, as JAX
  hops with ``ppermute``;
* in one process (:func:`gpipe_on_one_device`): every stage runs in
  lockstep, each hop handing one stage's output to the next in memory.

torch's autograd does not differentiate through send and recv, so the
schedule is one ``torch.autograd.Function`` (:class:`_Pipeline`) whose
backward runs the ticks in reverse: each stage receives the gradient of
its output from the next stage, takes the stage function's vector-Jacobian
product (recomputing the stage when ``remat_stage``, as
``jax.checkpoint(stage_fn)`` does, else from the graph its forward kept)
and sends the gradient of its input back. Every rank issues the same
exchanges in the same order, forward and backward.

Ticks whose item lies outside ``[0, v·M)`` (the bubble) compute nothing:
JAX computes garbage there that never reaches the result, so skipping it
changes no value, and their gradients are exactly zero. A hop carries a
tensor only where its sender's item is live and is passed on; both ends
know which hops carry one.

Gradients (the axes each leaf is summed over): a stage's layer rows take
gradients from its own ticks only, summed over the data axes like any
batch-sharded gradient and never over ``pipeline``. The input's gradient
lives on stage 0 alone; the backward broadcasts it to every stage (the
transpose of JAX's replicated input), so the leaves outside the stages
(embeddings, ``ln_f``, the head), which every stage computes alike, end
with the whole model's gradient on every stage and are summed over the
data axes only: not S times it, nor 1/S of it.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

BATCH_AXES = ("data", "fsdp", "expert")


def pipeline_degree(mesh: Any) -> int:
    """The ``pipeline`` axis size of a mesh (distributed/mesh.py), 1 for none."""
    return int(mesh.sizes.get("pipeline", 1)) if mesh is not None else 1


def _interleave_permutation(n_layers: int, n_stages: int, v: int) -> np.ndarray:
    """Row order that makes a CONTIGUOUS shard hold strided chunks: stage
    ``s`` holds global chunks s, s+S, …, s+(v−1)S, its local rows ordered
    (round r, layer-in-chunk j)."""
    lc = n_layers // (n_stages * v)
    return np.asarray(
        [
            r * n_stages * lc + s * lc + j
            for s in range(n_stages)
            for r in range(v)
            for j in range(lc)
        ],
        dtype=np.int64,
    )


def round_of(k: int, n_micro: int, v: int) -> int:
    """The chunk round of work item ``k`` (JAX's clamp for out-of-range items)."""
    return min(max(max(k, 0) // n_micro, 0), v - 1)


def micro_of(k: int, n_micro: int, v: int) -> int:
    """The microbatch of work item ``k``, clamped as JAX clamps it."""
    return min(max(max(k, 0) - round_of(k, n_micro, v) * n_micro, 0), n_micro - 1)


class _Schedule:
    """The tick arithmetic of one stage of an ``S``-stage, ``M``-microbatch,
    ``v``-round pipeline."""

    def __init__(self, stage: int, n_stages: int, n_micro: int, v: int) -> None:
        self.stage, self.n_stages, self.n_micro, self.v = stage, n_stages, n_micro, v
        self.ticks = v * n_micro + n_stages - 1
        self.last = n_stages - 1

    def live(self, k: int) -> bool:
        return 0 <= k < self.v * self.n_micro

    def carries(self, t: int, sender: int) -> bool:
        """Whether the hop after tick ``t`` from stage ``sender`` carries a
        tensor: its item is live and goes on (from the last stage, only an
        item with a round still to run)."""
        k = t - sender
        if not self.live(k):
            return False
        return sender != self.last or k < (self.v - 1) * self.n_micro

    def banks(self, t: int) -> bool:
        """Stage 0 banks the activation returning at tick ``t``."""
        k_ret = t - self.n_stages
        return self.stage == 0 and 0 <= k_ret < (self.v - 1) * self.n_micro

    def result(self, t: int) -> bool:
        """The last stage finishes a final-round item at tick ``t``."""
        k_out = t - self.last
        return (self.stage == self.last
                and (self.v - 1) * self.n_micro <= k_out < self.v * self.n_micro)

    def prev(self) -> int:
        return (self.stage - 1) % self.n_stages


def _chunk(params: dict[str, torch.Tensor], r: int, lc: int) -> dict[str, torch.Tensor]:
    return {name: p[r * lc:(r + 1) * lc] for name, p in params.items()}


def _call(fn: Callable, chunk: dict[str, torch.Tensor], h: torch.Tensor,
          mask: torch.Tensor | None) -> torch.Tensor:
    return fn(chunk, h) if mask is None else fn(chunk, h, mask)


def _forward_ticks(fn: Callable, params: dict[str, torch.Tensor], xm: torch.Tensor,
                   mask_m: torch.Tensor | None, sched: _Schedule, lc: int, save: str):
    """One stage's forward, as a generator: after each tick but the last it
    yields ``(tensor to send or None, template of the tensor it receives or
    None)`` and is sent what it receives. Returns ``(results, saved)``:
    the last stage's final-round outputs by microbatch, and per live tick
    what the backward needs (``save``: ``"graph"`` keeps the stage's graph,
    ``"input"`` its input for a recompute, ``"none"`` nothing)."""
    s, n_micro, v = sched.stage, sched.n_micro, sched.v
    like = torch.empty_like(xm[0])
    state_in: torch.Tensor | None = None
    ret_buf: list[torch.Tensor | None] = [None] * n_micro
    results: list[torch.Tensor | None] = [None] * n_micro
    saved: dict[int, Any] = {}
    for t in range(sched.ticks):
        if sched.banks(t):
            ret_buf[micro_of(t - sched.n_stages, n_micro, v)] = state_in
        k = t - s
        out = None
        if sched.live(k):
            if s == 0:
                m0 = micro_of(t, n_micro, v)
                inp = xm[m0] if round_of(t, n_micro, v) == 0 else ret_buf[m0]
            else:
                inp = state_in
            chunk = _chunk(params, round_of(k, n_micro, v), lc)
            mask = None if mask_m is None else mask_m[micro_of(k, n_micro, v)]
            if save == "graph":
                with torch.enable_grad():
                    inp_leaf = inp.detach().requires_grad_()
                    leaves = {n: c.detach().requires_grad_() for n, c in chunk.items()}
                    graph_out = _call(fn, leaves, inp_leaf, mask)
                saved[t] = (inp_leaf, leaves, graph_out)
                out = graph_out.detach()
            else:
                if save == "input":
                    saved[t] = inp
                out = _call(fn, chunk, inp, mask)
            if sched.result(t):
                results[micro_of(t - sched.last, n_micro, v)] = out
        if t < sched.ticks - 1:
            state_in = yield (out if sched.carries(t, s) else None,
                              like if sched.carries(t, sched.prev()) else None)
    return results, saved


def _backward_ticks(fn: Callable, params: dict[str, torch.Tensor], mask_m: torch.Tensor | None,
                    saved: dict[int, Any], g_results: torch.Tensor | None, sched: _Schedule,
                    lc: int, like: torch.Tensor):
    """One stage's backward, a generator as :func:`_forward_ticks` with the
    hops reversed: before each reverse tick but the first it yields ``(the
    gradient of its input to send back or None, template of the gradient
    it receives or None)``. Returns ``(gradient of each fresh microbatch
    or None, gradient of each parameter)``."""
    s, n_micro, v = sched.stage, sched.n_micro, sched.v
    g_params = {n: torch.zeros_like(p) for n, p in params.items()}
    g_x: list[torch.Tensor | None] = [None] * n_micro
    g_ret: list[torch.Tensor | None] = [None] * n_micro
    g_state: torch.Tensor | None = None
    for t in reversed(range(sched.ticks)):
        g_out = None
        if t < sched.ticks - 1:
            g_out = yield (g_state if sched.carries(t, sched.prev()) else None,
                           like if sched.carries(t, s) else None)
        if sched.result(t):
            g_res = g_results[micro_of(t - sched.last, n_micro, v)]
            g_out = g_res if g_out is None else g_out + g_res
        k = t - s
        g_inp = None
        if sched.live(k):
            r = round_of(k, n_micro, v)
            mask = None if mask_m is None else mask_m[micro_of(k, n_micro, v)]
            entry = saved[t]
            if isinstance(entry, tuple):
                inp_leaf, leaves, out = entry
            else:
                with torch.enable_grad():
                    inp_leaf = entry.detach().requires_grad_()
                    leaves = {n: c.detach().requires_grad_()
                              for n, c in _chunk(params, r, lc).items()}
                    out = _call(fn, leaves, inp_leaf, mask)
            names = list(leaves)
            grads = torch.autograd.grad(out, [inp_leaf, *(leaves[n] for n in names)], g_out,
                                        allow_unused=True)
            g_inp = grads[0]
            for n, g in zip(names, grads[1:]):
                if g is not None:
                    g_params[n][r * lc:(r + 1) * lc] += g
            saved.pop(t)
        if s == 0:
            if g_inp is not None:
                m0 = micro_of(t, n_micro, v)
                bucket = g_x if round_of(t, n_micro, v) == 0 else g_ret
                bucket[m0] = g_inp if bucket[m0] is None else bucket[m0] + g_inp
            g_state = None
            if sched.banks(t):
                slot = micro_of(t - sched.n_stages, n_micro, v)
                g_state, g_ret[slot] = g_ret[slot], None
        else:
            g_state = g_inp
    return g_x, g_params


# --------------------------------------------------------------------------
# transports
# --------------------------------------------------------------------------


class _Lockstep:
    """Every stage in this process: a hop hands stage i's tensor to stage
    i + ``direction`` in memory."""

    def __init__(self, n_stages: int) -> None:
        self.stages = list(range(n_stages))

    def drive(self, gens: list, direction: int) -> list:
        n = len(gens)
        results: list[Any] = [None] * n
        step = [g.send(None) for g in gens]  # first exchange request of each stage
        done = [False] * n
        while not all(done):
            nxt = []
            for i, g in enumerate(gens):
                if done[i]:
                    nxt.append(None)
                    continue
                sent, want = step[(i - direction) % n][0], step[i][1]
                if (want is None) != (sent is None):
                    raise RuntimeError(f"pipeline hop to stage {i} does not match its sender")
                try:
                    nxt.append(g.send(sent))
                except StopIteration as stop:
                    results[i] = stop.value
                    done[i] = True
                    nxt.append(None)
            step = nxt
        return results

    def from_last(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def from_first(self, t: torch.Tensor) -> torch.Tensor:
        return t


class _Group:
    """This rank's stage over its pipeline group: a hop is one batch of
    point-to-point operations with the neighbouring stages."""

    def __init__(self, mesh: Any) -> None:
        self.group = mesh.group("pipeline")
        self.ranks = mesh.group_ranks("pipeline")
        self.index = mesh.index("pipeline")
        self.stages = [self.index]

    def drive(self, gens: list, direction: int) -> list:
        import torch.distributed as dist

        from ..distributed import collective_errors

        (gen,) = gens
        n = len(self.ranks)
        dst = self.ranks[(self.index + direction) % n]
        src = self.ranks[(self.index - direction) % n]
        try:
            send, want = gen.send(None)
            while True:
                ops, received = [], None
                if send is not None:
                    ops.append(dist.P2POp(dist.isend, send.contiguous(), dst, self.group))
                if want is not None:
                    received = torch.empty_like(want)
                    ops.append(dist.P2POp(dist.irecv, received, src, self.group))
                if ops:
                    with collective_errors():
                        for work in dist.batch_isend_irecv(ops):
                            work.wait()
                send, want = gen.send(received)
        except StopIteration as stop:
            return [stop.value]

    def _broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        import torch.distributed as dist

        from ..distributed import collective_errors

        t = t.contiguous()
        with collective_errors():
            dist.broadcast(t, src=self.ranks[stage], group=self.group)
        return t

    def from_last(self, t: torch.Tensor) -> torch.Tensor:
        return self._broadcast(t, len(self.ranks) - 1)

    def from_first(self, t: torch.Tensor) -> torch.Tensor:
        return self._broadcast(t, 0)


def _stack(parts: list[torch.Tensor | None], like: torch.Tensor) -> torch.Tensor:
    return torch.stack([p if p is not None else torch.zeros_like(like) for p in parts])


class _Pipeline(torch.autograd.Function):
    """The schedule with its reverse: inputs ``(run, xm, mask_m, *params of
    each local stage in order)``, output the (M, mb, ...) result every
    local stage holds."""

    @staticmethod
    def forward(ctx, run, xm, mask_m, *flat):
        stages = run.split(flat)
        save = "input" if run.remat else "graph"
        out = run.forward(stages, xm, mask_m, save)
        ctx.run, ctx.mask_m = run, mask_m
        ctx.save_for_backward(*flat)
        ctx.like = xm[0]
        return out

    @staticmethod
    def backward(ctx, g_out):
        run = ctx.run
        stages = run.split(ctx.saved_tensors)
        g_xm, g_params = run.backward(stages, ctx.mask_m, g_out.contiguous(), ctx.like)
        flat = [g for g_stage in g_params for g in (g_stage[n] for n in run.names)]
        return (None, g_xm, None, *flat)


class _Run:
    """One call of the schedule: the stage function and the shapes, the
    transport, and the saved state between forward and backward."""

    def __init__(self, fn: Callable, names: list[str], transport: Any, n_stages: int,
                 n_micro: int, v: int, lc: int, remat: bool) -> None:
        self.fn, self.names, self.transport = fn, names, transport
        self.n_stages, self.n_micro, self.v, self.lc, self.remat = (
            n_stages, n_micro, v, lc, remat)
        self.saved: list[dict[int, Any]] = []

    def split(self, flat: tuple) -> list[dict[str, torch.Tensor]]:
        n = len(self.names)
        return [dict(zip(self.names, flat[i * n:(i + 1) * n]))
                for i in range(len(self.transport.stages))]

    def _sched(self, stage: int) -> _Schedule:
        return _Schedule(stage, self.n_stages, self.n_micro, self.v)

    def forward(self, stages: list[dict[str, torch.Tensor]], xm: torch.Tensor,
                mask_m: torch.Tensor | None, save: str) -> torch.Tensor:
        gens = [_forward_ticks(self.fn, p, xm, mask_m, self._sched(s), self.lc, save)
                for s, p in zip(self.transport.stages, stages)]
        done = self.transport.drive(gens, +1)
        self.saved = [saved for _, saved in done]
        last = self.transport.stages.index(self.n_stages - 1) \
            if self.n_stages - 1 in self.transport.stages else None
        out = (_stack(done[last][0], xm[0]) if last is not None
               else torch.empty_like(xm))
        return self.transport.from_last(out)

    def backward(self, stages: list[dict[str, torch.Tensor]], mask_m: torch.Tensor | None,
                 g_out: torch.Tensor, like: torch.Tensor):
        gens = [_backward_ticks(self.fn, p, mask_m, saved, g_out, self._sched(s), self.lc, like)
                for s, p, saved in zip(self.transport.stages, stages, self.saved)]
        done = self.transport.drive(gens, -1)
        self.saved = []
        first = self.transport.stages.index(0) if 0 in self.transport.stages else None
        g_xm = (_stack(done[first][0], like) if first is not None
                else torch.empty((self.n_micro, *like.shape), dtype=like.dtype,
                                 device=like.device))
        return self.transport.from_first(g_xm), [g for _, g in done]


def _check(n_stages: int, n_micro: int, v: int, n_layers: int) -> None:
    if n_micro < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_micro}")
    if v < 1:
        raise ValueError(f"virtual_chunks must be >= 1, got {v}")
    if v > 1 and n_micro < n_stages:
        raise ValueError(
            f"interleaved schedule needs n_microbatches ({n_micro}) >= "
            f"stage count ({n_stages}): a microbatch returns to stage 0 "
            "S ticks after entering and must not overtake its re-entry slot"
        )
    if n_layers % (n_stages * v) != 0:
        raise ValueError(
            f"layer count {n_layers} must divide stages x virtual_chunks "
            f"({n_stages} x {v})"
        )


def _micro_split(x: torch.Tensor, mask: torch.Tensor | None, n_micro: int):
    batch = x.shape[0]
    if batch % n_micro != 0:
        raise ValueError(
            f"per-shard batch {batch} not divisible by n_microbatches {n_micro}"
        )
    mb = batch // n_micro
    xm = x.reshape(n_micro, mb, *x.shape[1:])
    mask_m = None if mask is None else mask.reshape(n_micro, mb, *mask.shape[1:])
    return xm, mask_m


def _schedule(fn: Callable, stages: list[dict[str, torch.Tensor]], x: torch.Tensor,
              mask: torch.Tensor | None, transport: Any, n_stages: int, n_micro: int, v: int,
              lc: int, remat: bool) -> torch.Tensor:
    xm, mask_m = _micro_split(x, mask, n_micro)
    names = list(stages[0])
    run = _Run(fn, names, transport, n_stages, n_micro, v, lc, remat)
    flat = [p[n] for p in stages for n in names]
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in flat)):
        out = _Pipeline.apply(run, xm, mask_m, *flat)
    else:
        out = run.forward(stages, xm, mask_m, "none")
    return out.reshape(x.shape)


def gpipe_apply(
    stage_fn: Callable[..., torch.Tensor],
    params: dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh: Any,
    *,
    n_microbatches: int,
    remat_stage: bool = True,
    virtual_chunks: int = 1,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Run ``x`` through all layers with pipeline scheduling over the
    mesh's ``pipeline`` group (JAX ``gpipe_apply``).

    ``params``: this rank's stage, each leaf its stored rows (the layer dim
    leading, split contiguously over ``pipeline``); ``stage_fn(layers, h)``
    (or ``(layers, h, mask)``) applies the given layers in order, with the
    collectives of any other axis the leaves are split over. ``x``: this
    rank's (B, T, D) rows. ``mask``: optional (B, T) padding mask, indexed
    per tick (it does not ride the ring). Returns (B, T, D) after all
    layers on every stage. On a one-stage mesh this is ``stage_fn`` itself.
    """
    n_stages = pipeline_degree(mesh)
    if n_stages == 1:
        return stage_fn(params, x) if mask is None else stage_fn(params, x, mask)
    n_micro, v = n_microbatches, virtual_chunks
    local_rows = next(iter(params.values())).shape[0]
    _check(n_stages, n_micro, v, local_rows * n_stages)
    transport = _Group(mesh)
    if v > 1:
        # The interleaved stage holds strided chunks: its rows of the
        # permuted stack (every stage's rows gathered, the gradient
        # reduce-scattered back to the rows each stage stores). The
        # checkpoint layout stays independent of (stages, chunks).
        from .collectives import gather_rs

        n_layers = local_rows * n_stages
        perm = _interleave_permutation(n_layers, n_stages, v)
        rows = torch.as_tensor(perm[transport.index * local_rows:
                                    (transport.index + 1) * local_rows], device=x.device)
        params = {n: gather_rs(p, 0, transport.group).index_select(0, rows)
                  for n, p in params.items()}
    lc = local_rows // v
    return _schedule(stage_fn, [params], x, mask, transport, n_stages, n_micro, v, lc,
                     remat_stage)


def gpipe_on_one_device(
    stage_fn: Callable[..., torch.Tensor],
    params: dict[str, torch.Tensor],
    x: torch.Tensor,
    n_stages: int,
    *,
    n_microbatches: int,
    remat_stage: bool = True,
    virtual_chunks: int = 1,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """The same schedule with every one of ``n_stages`` stages in this
    process, in lockstep: ``params`` is the whole stack (the layer dim
    leading, in layer order), split into the stages' rows (the interleaved
    stages' strided chunks) here. The stages' arithmetic is the mesh's,
    checkable against the sequential stack on one device."""
    if n_stages == 1:
        return stage_fn(params, x) if mask is None else stage_fn(params, x, mask)
    n_micro, v = n_microbatches, virtual_chunks
    n_layers = next(iter(params.values())).shape[0]
    _check(n_stages, n_micro, v, n_layers)
    per = n_layers // n_stages
    if v > 1:
        perm = torch.as_tensor(_interleave_permutation(n_layers, n_stages, v), device=x.device)
        params = {n: p.index_select(0, perm) for n, p in params.items()}
    stages = [{n: p[s * per:(s + 1) * per] for n, p in params.items()} for s in range(n_stages)]
    return _schedule(stage_fn, stages, x, mask, _Lockstep(n_stages), n_stages, n_micro, v,
                     per // v, remat_stage)


__all__ = ["BATCH_AXES", "gpipe_apply", "gpipe_on_one_device", "pipeline_degree"]
