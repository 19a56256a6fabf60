"""Per-layer activation-tier specs (``model.extra.activation_tiers``).

The port's copy of the parser in ``llmtrain_tpu/config/activation_tiers.py``
— the config schema validates the spec at load time, so a preset that
fails there fails here too. Grammar: ``tier:range`` entries joined by
commas, ``range`` is ``*``, ``INT`` or ``INT-INT`` (inclusive, 0-based).
"""

from __future__ import annotations

TIERS = ("none", "selective", "full", "offload")


def parse_activation_tiers(spec: str, n_layers: int) -> tuple[str, ...]:
    """Parse ``spec`` into one tier per layer (length ``n_layers``).

    Raises :class:`ValueError` naming the offending entry for unknown
    tiers, malformed ranges, out-of-range layer indices, overlapping
    assignments, or a ``*`` combined with other entries.
    """
    if n_layers < 1:
        raise ValueError(f"n_layers must be >= 1 (got {n_layers})")
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(
            "activation_tiers spec must be a non-empty string like "
            "'offload:0-3,full:4-11' or 'full:*'"
        )
    entries = [e.strip() for e in spec.strip().split(",")]
    out: list[str | None] = [None] * n_layers
    for entry in entries:
        if not entry:
            raise ValueError(
                f"activation_tiers spec {spec!r} has an empty entry "
                "(stray comma?)"
            )
        tier, sep, rng = entry.partition(":")
        if not sep or not rng:
            raise ValueError(
                f"activation_tiers entry {entry!r} is malformed; expected "
                "'tier:range' like 'offload:0-3' or 'full:*'"
            )
        if tier not in TIERS:
            raise ValueError(
                f"activation_tiers entry {entry!r} names unknown tier "
                f"{tier!r}; expected one of {list(TIERS)}"
            )
        if rng == "*":
            if len(entries) != 1:
                raise ValueError(
                    f"activation_tiers entry {entry!r} uses '*' alongside "
                    "other entries; '*' must be the only entry"
                )
            return (tier,) * n_layers
        lo_s, dash, hi_s = rng.partition("-")
        try:
            lo = int(lo_s)
            hi = int(hi_s) if dash else lo
        except ValueError:
            raise ValueError(
                f"activation_tiers entry {entry!r} has a malformed layer "
                "range; expected an int or 'lo-hi'"
            ) from None
        if lo > hi:
            raise ValueError(
                f"activation_tiers entry {entry!r} has an inverted range "
                f"({lo} > {hi})"
            )
        if lo < 0 or hi >= n_layers:
            raise ValueError(
                f"activation_tiers entry {entry!r} is out of range for a "
                f"{n_layers}-layer model (valid layers: 0-{n_layers - 1})"
            )
        for layer in range(lo, hi + 1):
            if out[layer] is not None:
                raise ValueError(
                    f"activation_tiers entry {entry!r} overlaps layer "
                    f"{layer}, already assigned tier {out[layer]!r}"
                )
            out[layer] = tier
    return tuple(t if t is not None else "none" for t in out)


def canonical_tier_spec(tiers: tuple[str, ...] | list[str]) -> str:
    """The compact canonical spelling of a per-layer tier tuple
    (``('full','full') -> 'full:*'``, ``('offload','full','full') ->
    'offload:0,full:1-2'``), so two spellings of one ladder compare equal."""
    if not tiers:
        raise ValueError("tiers must be non-empty")
    for t in tiers:
        if t not in TIERS:
            raise ValueError(f"unknown tier {t!r}; expected one of {list(TIERS)}")
    if len(set(tiers)) == 1:
        return f"{tiers[0]}:*"
    runs: list[tuple[str, int, int]] = []
    for i, t in enumerate(tiers):
        if runs and runs[-1][0] == t and runs[-1][2] == i - 1:
            runs[-1] = (t, runs[-1][1], i)
        else:
            runs.append((t, i, i))
    return ",".join(f"{t}:{lo}" if lo == hi else f"{t}:{lo}-{hi}" for t, lo, hi in runs)


__all__ = ["TIERS", "canonical_tier_spec", "parse_activation_tiers"]
