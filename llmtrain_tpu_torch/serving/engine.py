"""Paged decode engine: bucketed prefill/decode over the block pool (port of
``llmtrain_tpu/serving/engine.py``).

The execution layer of the continuous-batching server (scheduler.py owns
WHEN sequences join/leave; this module owns HOW a step runs):

* **Three steps, shape-bucketed.** ``prefill`` runs one joining
  sequence's prompt slab (padded to a prompt-length bucket) through the
  paged model, writing its K/V blocks and sampling its first token;
  ``decode`` advances every in-flight sequence one token (batch padded to
  a batch-size bucket); ``verify`` scores every row's ``gamma + 1``-token
  speculative slab in one call (batch bucketed, width fixed per call) and
  returns the argmax at every position. Eager PyTorch compiles nothing, so
  :meth:`compile_stats` counts the distinct shapes the engine ran, against
  the budget JAX's compile count is held to, ``len(prompt_buckets) +
  len(batch_buckets)`` plus ``len(batch_buckets)`` per verify width used:
  within it means the shapes stayed bucketed.
* **Per-row sampling that replays generate().** Greedy rows take the raw
  argmax and draw nothing; sampled rows draw from their own
  ``torch.Generator`` (seeded as ``serve`` seeds a request), one draw per
  emitted token on their own (1, V) probabilities, after the temperature
  and the top-k/top-p filter of ``generation.filter_logits`` — so a
  batched request emits the tokens ``generate()`` emits for it alone. The
  logits themselves do not depend on the batch: the paged model runs
  every row-wise op and every attention product at one fixed shape
  (``models/gpt.py`` DECODE_ROWS).
* **Shared pool cache.** The paged cache does not depend on the batch size
  (``GPTPagedDecoder``), so every bucket reads and writes the same pool
  tensors; join/evict never copies K/V.

Every step runs under ``torch.inference_mode()``. :meth:`cost_profile`
counts the prefill and decode steps at their largest buckets on ``meta``
tensors (telemetry/profiling.py): nothing executes and the live pool is
untouched.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..generation import filter_logits
from .paged_kv import PagedKVPool


def _round_up_buckets(limit: int, *, start: int = 1) -> list[int]:
    """Powers of two up to (and always including) ``limit``."""
    buckets: list[int] = []
    b = start
    while b < limit:
        buckets.append(b)
        b *= 2
    buckets.append(limit)
    return buckets


def bucket_for(n: int, buckets: list[int]) -> int:
    """Smallest bucket >= n; raises when n exceeds every bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket ({buckets[-1]})")


def _filter_rows(
    scaled: torch.Tensor, top_ks: list[int | None], top_ps: list[float | None]
) -> torch.Tensor:
    """Per-row top-k / top-p masking with per-row knobs (JAX
    ``_filter_rows``). ``top_ks[i]`` <= 0 or None and ``top_ps[i]`` outside
    (0, 1) or None disable the filter on row i, generate()'s conventions.
    Each row is filtered on its own (1, V) slice by
    ``generation.filter_logits``, so a served row keeps exactly what
    generate() keeps."""
    out = []
    for i, (k, p) in enumerate(zip(top_ks, top_ps)):
        k = k if k is not None and k > 0 else None
        p = p if p is not None and 0.0 < p < 1.0 else None
        out.append(filter_logits(scaled[i : i + 1], top_k=k, top_p=p))
    return torch.cat(out)


def _sample_rows(logits: torch.Tensor, rows: list[dict[str, Any]]) -> list[int]:
    """One sampling decision per row of ``logits`` (B, V) f32, generate()-
    exact per request: greedy rows (temperature 0) the raw argmax, sampled
    rows ``multinomial(softmax(filter(row / temperature)))`` on their (1, V)
    row with their generator (``_sample_next`` of generation.py for a
    batch of one)."""
    toks = torch.argmax(logits, dim=-1)
    for i, r in enumerate(rows):
        temp = float(r["temperature"])
        if temp == 0.0:
            continue
        scaled = _filter_rows(logits[i : i + 1] / temp, [r["top_k"]], [r["top_p"]])
        probs = torch.softmax(scaled, dim=-1)
        toks[i] = torch.multinomial(probs, 1, generator=r["generator"])[0, 0]
    return toks[: len(rows)].tolist()


class PagedDecodeEngine:
    """Bucketed paged-KV decode over one model.

    Owns the device pool, the host-side pool allocator, the bucket policy
    and the shape accounting. ``params`` is a model carrying its weights (a
    GPT on the serving device): the engine's own by default, or another
    one of the same architecture passed per call (a hot swap pins
    in-flight rows to the model they were admitted with). The scheduler
    calls :meth:`prefill` / :meth:`decode`; nothing here decides admission.
    """

    def __init__(
        self,
        model: Any,
        *,
        block_tokens: int = 16,
        num_blocks: int | None = None,
        max_batch_slots: int = 8,
        prompt_buckets: list[int] | None = None,
        batch_buckets: list[int] | None = None,
        prefix_cache: bool = False,
        prefill_chunk: int = 0,
    ) -> None:
        if not hasattr(model, "for_paged_decoding"):
            raise ValueError(
                "paged serving needs a model exposing for_paged_decoding(); "
                f"{type(model).__name__} does not"
            )
        self.params = model
        self.block_size = int(model.block_size)
        self.block_tokens = int(block_tokens)
        self.max_blocks_per_seq = -(-self.block_size // self.block_tokens)
        if num_blocks is None:
            # Default: every slot can host a worst-case sequence, + null.
            num_blocks = 1 + max_batch_slots * self.max_blocks_per_seq
        self.max_batch_slots = int(max_batch_slots)
        self.prompt_buckets = sorted(
            prompt_buckets or _round_up_buckets(self.block_size, start=8)
        )
        self.batch_buckets = sorted(
            batch_buckets or _round_up_buckets(self.max_batch_slots)
        )
        if self.prompt_buckets[-1] > self.block_size:
            raise ValueError(
                f"largest prompt bucket ({self.prompt_buckets[-1]}) exceeds "
                f"the model block_size ({self.block_size})"
            )
        if self.batch_buckets[-1] != self.max_batch_slots:
            raise ValueError(
                f"largest batch bucket ({self.batch_buckets[-1]}) must equal "
                f"max_batch_slots ({self.max_batch_slots})"
            )
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0 (0 = off), got {prefill_chunk}"
            )
        if self.prefill_chunk > self.prompt_buckets[-1]:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) exceeds the largest "
                f"prompt bucket ({self.prompt_buckets[-1]}) — chunks must "
                "pad into an existing bucket (the bounded-shape contract)"
            )
        self.num_blocks = int(num_blocks)
        self.decode_model = model.for_paged_decoding(
            num_blocks=self.num_blocks, block_tokens=self.block_tokens
        )
        self.device = model.token_embedding.weight.device
        self.pool = PagedKVPool(
            self.num_blocks, self.block_tokens, prefix_cache=prefix_cache
        )
        # One pool for every bucket: its shape does not depend on the batch.
        self._cache = self.decode_model.init_pool()
        # Bumped whenever a failed step zeroes the pool: the scheduler
        # compares epochs to learn that in-flight KV was lost.
        self.cache_epoch = 0
        self._prefill_shapes: set[int] = set()
        self._decode_shapes: set[int] = set()
        self._verify_shapes: set[tuple[int, int]] = set()
        self._cow_used = False
        # Optional ``(kind, bucket) -> None`` hook, fired the first time a
        # bucket shape runs (where JAX compiles a program). The scheduler
        # wires it to a timeline instant, ``serve/compile`` as in JAX.
        self.on_compile: Any = None

    def _note_shape(self, shapes: set, key: Any, kind: str, bucket: int) -> None:
        if key in shapes:
            return
        shapes.add(key)
        if self.on_compile is not None:
            try:
                self.on_compile(kind, bucket)
            except Exception:  # noqa: BLE001 — telemetry must not fail a step
                pass

    # --------------------------------------------------------- validation

    def validate_request(self, prompt_len: int, max_new_tokens: int) -> str | None:
        """Why this engine can never serve the request, or None if it can.

        Checked at ADMISSION (scheduler) and at the HTTP boundary (400,
        not a late 500): the model's context bound, the largest prompt
        bucket (prefill cannot pad past it), and the pool's total
        capacity — a request whose worst-case block need exceeds the
        whole pool would otherwise sit at the FIFO head forever, starving
        everything behind it (try_reserve can only say "not yet").
        """
        prompt_len, total = int(prompt_len), int(prompt_len) + int(max_new_tokens)
        if total > self.block_size:
            return (
                f"prompt+max_new_tokens ({total}) exceeds the model "
                f"block_size ({self.block_size})"
            )
        if self.prefill_chunk == 0 and prompt_len > self.prompt_buckets[-1]:
            # Chunked prefill lifts this bound: chunks of <= prefill_chunk
            # tokens each pad into an existing bucket.
            return (
                f"prompt length ({prompt_len}) exceeds the largest "
                f"serving prompt bucket ({self.prompt_buckets[-1]})"
            )
        capacity = self.pool.num_blocks - 1
        need = self.pool.blocks_needed(total)
        if need > capacity:
            return (
                f"request needs {need} worst-case KV blocks but the pool "
                f"only holds {capacity} — raise serving.num_blocks or "
                f"lower max_new_tokens"
            )
        return None

    # ----------------------------------------------------------- stepping

    def _decoder(self, params: Any | None) -> Any:
        if params is None or params is self.params:
            return self.decode_model
        return params.for_paged_decoding(
            num_blocks=self.num_blocks, block_tokens=self.block_tokens
        )

    def _tensor(self, rows: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    def prefill(
        self,
        prompt_ids: np.ndarray,  # (Tp,) — the slab to run (suffix of the
        # prompt under prefix reuse / one chunk under chunking)
        table_padded: list[int],
        *,
        temperature: float,
        top_k: int | None,
        top_p: float | None,
        generator: torch.Generator | None = None,
        offset: int = 0,  # absolute position of prompt_ids[0]
        params: Any | None = None,  # hot-swap: the admitted epoch's model
        sample: bool = True,
    ) -> int | None:
        """Run one joining sequence's prompt slab; returns the token
        sampled at its last real position when ``sample`` (the slab that
        ends the prompt), else None: a chunk that does not end the prompt
        draws nothing from the row's generator."""
        tp = int(prompt_ids.shape[0])
        tb = bucket_for(tp, self.prompt_buckets)
        self._note_shape(self._prefill_shapes, tb, "prefill", tb)
        prompt = np.zeros((1, tb), np.int64)
        prompt[0, :tp] = prompt_ids
        try:
            with torch.inference_mode():
                logits = self._decoder(params)(
                    self._tensor(prompt),
                    self._tensor([int(offset)]),
                    self._tensor([table_padded]),
                    self._cache,
                    true_len=self._tensor([tp]),
                )
                if not sample:
                    return None
                # Sample at the LAST REAL position; padded positions wrote
                # into the null block and their logits are not read.
                row = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                           generator=generator)
                return _sample_rows(logits[:, tp - 1].float(), [row])[0]
        except Exception:
            self._recover_cache_after_error()
            raise

    def decode(
        self, rows: list[dict[str, Any]], *, params: Any | None = None
    ) -> list[int]:
        """Advance every row one token; returns next tokens, row-aligned.

        Each row dict: ``token`` (last emitted), ``position`` (its
        absolute position), ``table`` (padded physical ids),
        ``temperature``, ``top_k``, ``top_p`` and ``generator`` (None for a
        greedy row). The batch is padded to a batch bucket with null-table
        rows whose attention is not computed and whose output is dropped.
        """
        n = len(rows)
        if n == 0:
            return []
        bb = bucket_for(n, self.batch_buckets)
        self._note_shape(self._decode_shapes, bb, "decode", bb)
        tokens = np.zeros((bb, 1), np.int64)
        positions = np.zeros((bb,), np.int64)
        tables = np.zeros((bb, self.max_blocks_per_seq), np.int64)
        for i, r in enumerate(rows):
            tokens[i, 0] = r["token"]
            positions[i] = r["position"]
            tables[i] = r["table"]
        try:
            with torch.inference_mode():
                logits = self._decoder(params)(
                    self._tensor(tokens),
                    self._tensor(positions),
                    self._tensor(tables),
                    self._cache,
                    rows=n,
                )
                return _sample_rows(logits[:n, 0].float(), rows)
        except Exception:
            self._recover_cache_after_error()
            raise

    def verify(self, rows: list[dict[str, Any]], *, width: int,
               params: Any | None = None) -> list[list[int]]:
        """Score a ``width``-token slab for every row in ONE bucketed call
        (batched speculative verify, JAX ``verify``). Each row dict:
        ``tokens`` (width ints: the last accepted token + the drafts),
        ``position`` (tokens[0]'s absolute position), ``table``. Returns each
        row's per-position argmax: the target's greedy continuation given
        every draft prefix. Writes the slab's K/V; rejected positions are
        overwritten when the corrected tokens are fed (position p maps to a
        fixed (block, slot), and queries never see past their own
        position)."""
        n = len(rows)
        if n == 0:
            return []
        bb = bucket_for(n, self.batch_buckets)
        self._note_shape(self._verify_shapes, (bb, width), "verify", bb)
        tokens = np.zeros((bb, width), np.int64)
        positions = np.zeros((bb,), np.int64)
        tables = np.zeros((bb, self.max_blocks_per_seq), np.int64)
        for i, r in enumerate(rows):
            if len(r["tokens"]) != width:
                raise ValueError(
                    f"verify row {i} holds {len(r['tokens'])} tokens, "
                    f"expected width {width}"
                )
            tokens[i] = r["tokens"]
            positions[i] = r["position"]
            tables[i] = r["table"]
        try:
            with torch.inference_mode():
                logits = self._decoder(params)(
                    self._tensor(tokens),
                    self._tensor(positions),
                    self._tensor(tables),
                    self._cache,
                    rows=n,
                )
                return torch.argmax(logits[:n].float(), dim=-1).tolist()
        except Exception:
            self._recover_cache_after_error()
            raise

    def cow_copy(self, src: int, dst: int) -> None:
        """Device-side copy-on-write: pool block ``src`` → ``dst`` in every
        layer's key and value pools. The pool's cow_last_shared() picks the
        pair; this is the write half of its contract (it runs before the
        next pool mutation can recycle ``src``)."""
        self._cow_used = True
        try:
            with torch.inference_mode():
                for t in (*self._cache.key, *self._cache.value):
                    t[dst] = t[src]
        except Exception:
            self._recover_cache_after_error()
            raise

    def _recover_cache_after_error(self) -> None:
        """A step that failed may have written part of its K/V (some
        layers, some rows): the pool is zeroed and ``cache_epoch`` bumped,
        so the scheduler fails the in-flight sequences whose KV went with
        it, and later requests start from a clean pool."""
        self._cache.zero_()
        self.cache_epoch += 1

    # --------------------------------------------------------- accounting

    def cost_profile(
        self,
        *,
        peaks: dict[str, float] | None = None,
        full: bool = True,
        top_k: int = 10,
    ) -> list[dict[str, Any]]:
        """Cost profiles of the prefill/decode steps at their LARGEST
        buckets (worst-case per-step cost; smaller buckets are strictly
        cheaper), counted on a ``meta`` copy of the model and of the pool
        (telemetry/profiling.py): nothing executes, no device memory is
        allocated, and the live pool and in-flight KV stay untouched. The
        count covers the model's logits; the host-side sampling is not a
        device program here. ``full=False`` gives the totals only. Failed
        profiles are dropped, not raised."""
        from ..telemetry import profiling

        if peaks is None:
            peaks = profiling.resolve_peaks()
        try:
            decoder = profiling.meta_module(self.params).for_paged_decoding(
                num_blocks=self.num_blocks, block_tokens=self.block_tokens
            )
            pool = decoder.init_pool()
        except Exception as exc:  # noqa: BLE001 — profiles are additive
            profiling.logger.warning("serving cost count skipped: %s", exc)
            return []

        def ids(*shape: int) -> torch.Tensor:
            return torch.empty(shape, dtype=torch.int64, device="meta")

        mb = self.max_blocks_per_seq
        tb = self.prompt_buckets[-1]
        bb = self.batch_buckets[-1]

        def prefill() -> None:
            with torch.inference_mode():
                decoder(ids(1, tb), ids(1), ids(1, mb), pool, true_len=ids(1))

        def decode() -> None:
            with torch.inference_mode():
                decoder(ids(bb, 1), ids(bb), ids(bb, mb), pool, rows=bb)

        profiles: list[dict[str, Any]] = []
        for name, fn in ((f"prefill_T{tb}", prefill), (f"decode_B{bb}", decode)):
            if full:
                prof = profiling.count_profile(fn, name=name, peaks=peaks, top_k=top_k)
            else:
                prof = profiling.count_cost_profile(fn, name=name)
            if prof is not None:
                profiles.append(prof)
        return profiles

    def compile_stats(self) -> dict[str, Any]:
        """Bucket usage against the bounded-shape budget, under JAX's keys.
        Eager PyTorch compiles nothing: a ``*_programs`` count is the number
        of distinct bucket shapes that kind of step ran, as JAX's
        ``_note_shape`` records them, and the budget is JAX's,
        ``len(prompt_buckets) + len(batch_buckets)``, plus
        ``len(batch_buckets)`` per verify width used, +1 once a COW copy
        ran. Within budget means every step ran at a bucket shape."""
        verify_widths = {w for _, w in self._verify_shapes}
        stats: dict[str, Any] = {
            "prompt_buckets": list(self.prompt_buckets),
            "batch_buckets": list(self.batch_buckets),
            "prefill_shapes_used": sorted(self._prefill_shapes),
            "decode_shapes_used": sorted(self._decode_shapes),
            "verify_shapes_used": sorted(self._verify_shapes),
            "budget": (
                len(self.prompt_buckets)
                + len(self.batch_buckets)
                + len(self.batch_buckets) * len(verify_widths)
                + (1 if self._cow_used else 0)
            ),
            "prefill_programs": len(self._prefill_shapes),
            "decode_programs": len(self._decode_shapes),
            "verify_programs": len(self._verify_shapes),
            "cow_programs": 1 if self._cow_used else 0,
        }
        stats["within_budget"] = (
            stats["prefill_programs"] + stats["decode_programs"]
            + stats["verify_programs"] + stats["cow_programs"]
            <= stats["budget"]
        )
        return stats

    # ---------------------------------------------------------- hot swap

    def set_params(self, params: Any) -> None:
        """Swap the default model between scheduler steps (checkpoint hot
        swap). Callers that pin a request to its admitted model pass it
        explicitly to prefill/decode/verify instead. The prefix cache must be
        invalidated by the caller (scheduler) — cached K/V is a function of
        the OLD weights."""
        self.decode_model = self._decoder(params)
        self.params = params


__all__ = [
    "PagedDecodeEngine",
    "bucket_for",
]
