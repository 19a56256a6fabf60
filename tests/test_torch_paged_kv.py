"""The port's paged KV pool allocator against the JAX package's.

The same scripted sequence of operations (reserve, grow, release, double
free, prefix match/bind/register, copy-on-write, invalidate) runs through
``llmtrain_tpu.serving.paged_kv.PagedKVPool`` and the port's copy; after
every operation the return value (or the error), every live table (its
physical blocks, shared run and reservation) and ``stats()`` must be equal.
Pure Python on both sides: no tolerance.
"""

from __future__ import annotations

from typing import Any

import pytest

from llmtrain_tpu.serving import paged_kv as jax_paged_kv
from llmtrain_tpu_torch.serving import paged_kv as port_paged_kv

_A = list(range(1, 13))  # a 12-token prompt
_B = _A[:9] + [40, 41, 42]  # shares 9 tokens with _A
_C = [7, 7, 7, 7, 7, 7]

# Each scenario: (pool kwargs, [(op, args...)]). Tables are named: "reserve"
# binds the returned table to its name; other ops refer to tables by name.
SCENARIOS: dict[str, tuple[dict, list[tuple]]] = {
    "reserve-grow-release": (
        dict(num_blocks=9, block_tokens=4),
        [("reserve", "t1", 10), ("reserve", "t2", 20), ("reserve", "t3", 1),
         ("grow", "t1", 4), ("grow", "t1", 4), ("grow", "t1", 12), ("grow", "t1", 13),
         ("grow", "t2", 7), ("padded", "t1", 5), ("padded", "t1", 2),
         ("release", "t1"), ("reserve", "t4", 8), ("grow", "t4", 8),
         ("release", "t2"), ("release", "t4")],
    ),
    "double-free": (
        dict(num_blocks=5, block_tokens=2),
        [("reserve", "t1", 4), ("grow", "t1", 4), ("release", "t1"), ("release", "t1"),
         ("grow", "t1", 2), ("reserve", "t2", 8), ("release", "t2")],
    ),
    "lifo-reuse": (
        dict(num_blocks=12, block_tokens=3),
        [("reserve", "a", 9), ("reserve", "b", 6), ("grow", "a", 9), ("grow", "b", 4),
         ("release", "a"), ("reserve", "c", 12), ("grow", "c", 12), ("grow", "b", 6),
         ("release", "b"), ("release", "c")],
    ),
    "prefix-match-bind-register": (
        dict(num_blocks=16, block_tokens=4, prefix_cache=True),
        [("match", _A), ("reserve", "a", 20), ("grow", "a", 12), ("register", "a", _A),
         ("match", _A), ("match", _B), ("reserve", "b", 20), ("match_bind", "b", _B),
         ("cow", "b"), ("cow", "b"), ("grow", "b", 12), ("register", "b", _B),
         ("release", "a"), ("match", _A), ("release", "b"), ("match", _B)],
    ),
    "evict-lru": (
        dict(num_blocks=6, block_tokens=4, prefix_cache=True),
        [("reserve", "a", 8), ("grow", "a", 8), ("register", "a", _A[:8]), ("release", "a"),
         ("reserve", "c", 20), ("grow", "c", 8), ("grow", "c", 16), ("grow", "c", 20),
         ("match", _A), ("release", "c"), ("match", _A)],
    ),
    "invalidate": (
        dict(num_blocks=12, block_tokens=4, prefix_cache=True),
        [("reserve", "a", 16), ("grow", "a", 12), ("register", "a", _A),
         ("reserve", "b", 16), ("match_bind", "b", _A), ("invalidate",), ("match", _A),
         ("release", "a"), ("release", "b"), ("reserve", "c", 40), ("grow", "c", 40),
         ("release", "c")],
    ),
    "short-prompt-and-disabled-cache": (
        dict(num_blocks=8, block_tokens=2),
        [("match", _C), ("reserve", "a", 6), ("grow", "a", 6), ("register", "a", _C),
         ("cow", "a"), ("bind_empty", "a"), ("release", "a")],
    ),
}


def _drive(module: Any, pool_kw: dict, ops: list[tuple]) -> list[Any]:
    """Run the scenario; returns one observation per operation."""
    pool = module.PagedKVPool(**pool_kw)
    tables: dict[str, Any] = {}
    out: list[Any] = []

    def show(value: Any) -> Any:
        if isinstance(value, module.BlockTable):
            return ("table", value.reserved, list(value.blocks), value.shared)
        if isinstance(value, module.PrefixMatch):
            return ("match", list(value.full_blocks), value.partial_block,
                    value.partial_tokens, value.matched_tokens, value.hit)
        return value

    for op, *args in ops:
        try:
            if op == "reserve":
                result = pool.try_reserve(args[1])
                if result is not None:
                    tables[args[0]] = result
            elif op == "grow":
                result = pool.grow(tables[args[0]], args[1])
            elif op == "release":
                result = pool.release(tables[args[0]])
            elif op == "padded":
                result = tables[args[0]].padded(args[1])
            elif op == "match":
                result = pool.match_prefix(args[0])
            elif op == "match_bind":
                result = pool.bind_prefix(tables[args[0]], pool.match_prefix(args[1]))
            elif op == "bind_empty":
                result = pool.bind_prefix(tables[args[0]], module.PrefixMatch())
            elif op == "register":
                result = pool.register_prefix(tables[args[0]], args[1])
            elif op == "cow":
                result = pool.cow_last_shared(tables[args[0]])
            elif op == "invalidate":
                result = pool.invalidate_prefix_cache()
            else:
                raise AssertionError(op)
            observed: Any = show(result)
        except (ValueError, RuntimeError) as exc:
            observed = (type(exc).__name__, str(exc))
        out.append((op, observed, {k: show(t) for k, t in tables.items()}, pool.stats(),
                    pool.available_blocks, pool.allocated_blocks, pool.cached_blocks))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pool_matches_jax_step_by_step(name: str) -> None:
    pool_kw, ops = SCENARIOS[name]
    theirs = _drive(jax_paged_kv, pool_kw, ops)
    ours = _drive(port_paged_kv, pool_kw, ops)
    for i, (t, o) in enumerate(zip(theirs, ours)):
        assert o == t, f"{name}: operation {i} {ops[i]} differs"


@pytest.mark.parametrize("tokens, bt", [(_A, 4), (_B, 4), (_A, 5), (_C, 2), ([], 3)])
def test_chain_hashes_match_jax(tokens: list[int], bt: int) -> None:
    assert port_paged_kv.chain_hashes(tokens, bt) == jax_paged_kv.chain_hashes(tokens, bt)


@pytest.mark.parametrize("kw", [dict(num_blocks=1, block_tokens=4),
                                dict(num_blocks=4, block_tokens=0)])
def test_constructor_refusals_match_jax(kw: dict) -> None:
    with pytest.raises(ValueError) as theirs:
        jax_paged_kv.PagedKVPool(**kw)
    with pytest.raises(ValueError) as ours:
        port_paged_kv.PagedKVPool(**kw)
    assert str(ours.value) == str(theirs.value)
