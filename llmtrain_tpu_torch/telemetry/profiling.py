"""Cost attribution and roofline analysis (the port's copy of
``llmtrain_tpu/telemetry/profiling.py``).

* **Cost count** — where JAX reads XLA's ``cost_analysis()`` off a lowered
  or compiled program, the port counts one call of the step itself:
  :func:`count_cost_profile` (totals) and :func:`count_profile` (totals,
  the per-op table and the roofline class) run the function on ``meta``
  tensors — shapes without storage, so nothing executes on any device and
  nothing is allocated — under a dispatch mode that counts every aten op:
  matmul flops by ``torch.utils.flop_counter``'s formulas, a flop per
  output element (per input element for a reduction) for the rest, and
  the operand + result bytes of every op that moves data. The
  hand-written kernels never reach the dispatcher (they are autograd
  Functions calling their extensions); given ``meta`` tensors their
  wrappers report their own closed-form flops and bytes (ops/cost.py) and
  appear in the table under their own names. :func:`meta_module` makes
  the storage-free copy of a model the count runs on.

* **Roofline attribution** — against a per-device-kind peak table
  (:data:`DEVICE_PEAKS`, config-overridable), each step and each top op
  is classified compute-/memory-/comms-bound by comparing
  ``flops/peak_flops`` vs ``bytes/hbm_bw`` vs ``collective_bytes/ici_bw``.

* **MFU reconciliation** — the analytical MFU (counted flops) against the
  measured tokens/s MFU (PaLM ``6N`` approximation, utils/hw.py). Their
  ratio is deterministic (step time cancels): ``counted_flops_per_step /
  (tokens_per_step * palm_flops_per_token)``; outside
  :data:`MFU_RECONCILE_BAND` one of the two flop models is wrong for this
  architecture, and the report says so.

No function here executes device code or raises into a step loop: a count
that fails returns None.

Not ported, having no PyTorch counterpart: the HLO parser, the compiled
executable's ``memory_analysis()`` and its compile time; a profile
carries no ``compile_time_s`` or ``memory`` key, as JAX's degraded path
leaves them out.
"""

from __future__ import annotations

import copy
import importlib
import sys
import threading
import time
from typing import Any, Callable, Iterable, Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..ops import cost as kernel_cost
from ..utils.logging import get_logger

logger = get_logger()

# --------------------------------------------------------------------------
# Device peak table
# --------------------------------------------------------------------------

# Per-chip peaks: bf16 FLOP/s, HBM bandwidth (bytes/s), and aggregate
# interconnect bandwidth (bytes/s, all links). JAX's TPU rows are kept;
# they set roofline *ratios*, not claims, and every entry is overridable
# via ``telemetry.device_peaks``. The h100 row is NVIDIA's H100 SXM
# datasheet: 989 TFLOP/s dense bf16 (utils/hw.py), 3.35 TB/s HBM3, and
# fourth-generation NVLink at 900 GB/s per GPU. The cpu row is a nominal
# placeholder so CPU runs still produce trend-comparable classifications.
DEVICE_PEAKS: dict[str, dict[str, float]] = {
    "v4": {"peak_flops": 275e12, "hbm_bytes_per_sec": 1228e9, "ici_bytes_per_sec": 270e9},
    "v5e": {"peak_flops": 197e12, "hbm_bytes_per_sec": 819e9, "ici_bytes_per_sec": 186e9},
    "v5 lite": {"peak_flops": 197e12, "hbm_bytes_per_sec": 819e9, "ici_bytes_per_sec": 186e9},
    "v5p": {"peak_flops": 459e12, "hbm_bytes_per_sec": 2765e9, "ici_bytes_per_sec": 540e9},
    "v6e": {"peak_flops": 918e12, "hbm_bytes_per_sec": 1640e9, "ici_bytes_per_sec": 360e9},
    "v6 lite": {"peak_flops": 918e12, "hbm_bytes_per_sec": 1640e9, "ici_bytes_per_sec": 360e9},
    "h100": {"peak_flops": 989e12, "hbm_bytes_per_sec": 3.35e12, "ici_bytes_per_sec": 900e9},
    "cpu": {"peak_flops": 2e11, "hbm_bytes_per_sec": 50e9, "ici_bytes_per_sec": 10e9},
}

_PEAK_KEYS = ("peak_flops", "hbm_bytes_per_sec", "ici_bytes_per_sec")


def _device_kind() -> str:
    try:
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 — no backend is a degraded profile, not an error
        pass
    return "cpu"


def resolve_peaks(
    device_kind: str | None = None,
    overrides: Mapping[str, float] | None = None,
) -> dict[str, float]:
    """Peak figures for ``device_kind`` (substring match), with config
    overrides merged on top.

    ``device_kind`` None reads the card's name (``torch.cuda.get_device_name``),
    or "cpu" without one — attribution must degrade, never raise.
    """
    kind = device_kind if device_kind is not None else _device_kind()
    kind = (kind or "cpu").lower()
    peaks = dict(DEVICE_PEAKS["cpu"])
    # Longest matching key wins so "v5 lite" beats "v5" styles of kind.
    best = ""
    for key, row in DEVICE_PEAKS.items():
        if key in kind and len(key) > len(best):
            best = key
            peaks = dict(row)
    peaks["device_kind"] = kind  # type: ignore[assignment]
    for key in _PEAK_KEYS:
        if overrides and key in overrides and overrides[key]:
            peaks[key] = float(overrides[key])
    return peaks


# --------------------------------------------------------------------------
# cost dict normalization
# --------------------------------------------------------------------------


def normalize_cost(raw: Any) -> dict[str, float]:
    """Flatten a cost dict (or a list of them, first entry first) to
    ``{property: float}``; None and malformed input give {}."""
    if raw is None:
        return {}
    if isinstance(raw, (list, tuple)):
        raw = raw[0] if raw else {}
    out: dict[str, float] = {}
    try:
        for key, value in dict(raw).items():
            if isinstance(value, (int, float)):
                out[str(key)] = float(value)
    except Exception:  # noqa: BLE001
        return {}
    return out


def cost_summary(raw: Any) -> dict[str, float]:
    """The three headline properties of a cost dict."""
    cost = normalize_cost(raw)
    return {
        "flops": cost.get("flops", 0.0),
        "bytes_accessed": cost.get("bytes accessed", cost.get("bytes_accessed", 0.0)),
        "transcendentals": cost.get("transcendentals", 0.0),
    }


# --------------------------------------------------------------------------
# The cost count
# --------------------------------------------------------------------------

_aten = torch.ops.aten

# Ops that only move data: bytes counted, flops 0.
_ZERO_FLOP_OPS = frozenset({
    "_to_copy", "copy", "copy_", "clone", "cat", "stack", "embedding",
    "embedding_dense_backward", "index_select", "gather", "scatter",
    "scatter_add", "scatter_add_", "index_put", "index_put_", "index_copy",
    "index_copy_", "slice_scatter", "select_scatter", "as_strided_scatter",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full",
    "full_like", "new_full", "fill", "fill_", "zero_", "arange", "rand",
    "rand_like", "randn", "randn_like", "constant_pad_nd", "repeat",
    "lift_fresh_copy",
})
# Ops that move nothing: allocation without a write, aliases, metadata.
_NO_COST_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_unsafe_view", "_reshape_alias",
})
_TRANSCENDENTAL_OPS = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log1p", "tanh", "sigmoid", "sqrt",
    "rsqrt", "erf", "pow", "sin", "cos", "_softmax", "_log_softmax", "gelu",
    "gelu_backward", "tanh_backward", "sigmoid_backward",
})
_COLLECTIVE_PREFIXES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                        "broadcast")


def _contracted(a: torch.Tensor, *_: Any, out_val: torch.Tensor, **__: Any) -> float:
    """2 · output elements · the contracted size (``a``'s last dim)."""
    return 2.0 * out_val.numel() * a.shape[-1]


def _matmul_formulas() -> dict[Any, Callable]:
    """``torch.utils.flop_counter``'s formulas, plus the composites that
    reach the dispatcher undecomposed where autograd is off (inference)."""
    from torch.utils.flop_counter import flop_registry

    return {**flop_registry, _aten.linear: _contracted, _aten.matmul: _contracted}


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


class _CostCount(TorchDispatchMode):
    """Per-op counts of everything dispatched under it. Refuses (raises)
    any op that would touch storage: an operand off the ``meta`` device,
    or a factory asked for a real device."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: dict[str, dict[str, float]] = {}
        self.kernels: set[str] = set()
        self._formulas = _matmul_formulas()
        self._lock = threading.Lock()

    def _add(self, name: str, flops: float, nbytes: float, transcendentals: float = 0.0,
             *, kernel: bool = False) -> None:
        with self._lock:
            entry = self.ops.setdefault(
                name,
                {"count": 0.0, "flops": 0.0, "bytes_accessed": 0.0, "transcendentals": 0.0},
            )
            entry["count"] += 1
            entry["flops"] += flops
            entry["bytes_accessed"] += nbytes
            entry["transcendentals"] += transcendentals
            if kernel:
                self.kernels.add(name)

    def record_kernel(self, name: str, flops: float, nbytes: float) -> None:
        self._add(name, flops, nbytes, kernel=True)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):  # noqa: ANN001
        kwargs = kwargs or {}
        flat_in, _ = tree_flatten((args, kwargs))
        tensors_in = [t for t in flat_in if isinstance(t, torch.Tensor)]
        for t in tensors_in:
            if t.device.type != "meta":
                raise RuntimeError(f"cost count: {func} got a tensor on {t.device}")
        device = kwargs.get("device")
        if device is not None and torch.device(device).type != "meta":
            raise RuntimeError(f"cost count: {func} asked for device {device}")
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_COST_OPS:
            return out
        flat_out, _ = tree_flatten(out)
        tensors_out = [t for t in flat_out if isinstance(t, torch.Tensor)]
        nbytes = sum(_nbytes(t) for t in tensors_in) + sum(_nbytes(t) for t in tensors_out)
        out_elems = float(sum(t.numel() for t in tensors_out))
        formula = self._formulas.get(func.overloadpacket)
        transcendentals = 0.0
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        elif name in _ZERO_FLOP_OPS or name.startswith(_COLLECTIVE_PREFIXES):
            flops = 0.0
        else:
            # Elementwise: a flop per output element; a reduction reads
            # more elements than it writes and counts its inputs.
            in_elems = float(max((t.numel() for t in tensors_in), default=0))
            flops = max(in_elems, out_elems)
            if name in _TRANSCENDENTAL_OPS:
                transcendentals = out_elems
        self._add(name, flops, nbytes, transcendentals)
        return out


# Modules torch imports on first use, whose import keeps the importing
# stack alive: ``torch._dynamo`` comes in on the first call of a function
# torch marks dynamo-disabled (a step on ``meta`` tensors makes one), and
# its import runs ``torch.fx.wrap``, whose frame holds itself in a
# reference cycle and, through ``f_back``, every frame below it.
_STACK_KEEPING_IMPORTS = ("torch._dynamo",)


def import_lazy_torch_modules() -> None:
    """Import :data:`_STACK_KEEPING_IMPORTS` on a thread of their own,
    whose stack is the only one the cycle keeps. Imported in a step under
    ``Trainer.fit``, they would keep ``fit``'s frame, and with it the
    trainer, its model and its optimizer state, until the cycle collector
    ran."""
    missing = [name for name in _STACK_KEEPING_IMPORTS if name not in sys.modules]
    if missing:
        worker = threading.Thread(target=lambda: [importlib.import_module(n) for n in missing],
                                  name="lazy-torch-imports", daemon=True)
        worker.start()
        worker.join()


def _count(fn: Callable, args: tuple) -> tuple[_CostCount, float]:
    import_lazy_torch_modules()
    counter = _CostCount()
    t0 = time.perf_counter()
    with kernel_cost.recording(counter.record_kernel), counter:
        fn(*args)
    return counter, time.perf_counter() - t0


def _totals(counter: _CostCount) -> dict[str, float]:
    return {
        key: sum(entry[key] for entry in counter.ops.values())
        for key in ("flops", "bytes_accessed", "transcendentals")
    }


def count_cost_profile(fn: Callable, args: tuple = (), *, name: str) -> dict[str, Any] | None:
    """Cost totals of one call of ``fn(*args)`` on ``meta`` tensors (the
    counterpart of JAX's ``lower_cost_profile``): flops, bytes_accessed,
    transcendentals, name, and ``lower_time_s``, the count's own seconds.
    Per device: a data-parallel step is counted on one rank's batch.
    Returns None on any failure (attribution is optional, the run is not)."""
    try:
        counter, seconds = _count(fn, args)
    except Exception as exc:  # noqa: BLE001
        logger.debug("cost count of %s failed: %s", name, exc)
        return None
    summary: dict[str, Any] = _totals(counter)
    summary["name"] = name
    summary["lower_time_s"] = round(seconds, 4)
    return summary


def top_ops(
    parsed: Mapping[str, Any],
    peaks: Mapping[str, float],
    *,
    k: int = 10,
    always: Iterable[str] = (),
) -> list[dict[str, Any]]:
    """The top-``k`` ops ranked by ``max(flops share, bytes share)``, each
    carrying its own roofline class; the ops named in ``always`` (the
    hand-written kernels) are listed whatever their rank."""
    ops: Mapping[str, Mapping[str, float]] = parsed.get("ops", {})
    totals: Mapping[str, float] = parsed.get("totals", {})
    total_flops = max(totals.get("flops", 0.0), 1.0)
    total_bytes = max(totals.get("bytes_accessed", 0.0), 1.0)
    rows: list[dict[str, Any]] = []
    for opcode, entry in ops.items():
        flops_frac = entry["flops"] / total_flops
        bytes_frac = entry["bytes_accessed"] / total_bytes
        if opcode.startswith(_COLLECTIVE_PREFIXES):
            op_class = "comms"
        elif entry["flops"] <= 0 and entry["bytes_accessed"] <= 0:
            continue  # no cost, no row
        else:
            compute_t = entry["flops"] / max(peaks.get("peak_flops", 1.0), 1.0)
            memory_t = entry["bytes_accessed"] / max(peaks.get("hbm_bytes_per_sec", 1.0), 1.0)
            op_class = "compute" if compute_t >= memory_t else "memory"
        rows.append(
            {
                "op": opcode,
                "count": int(entry["count"]),
                "flops": entry["flops"],
                "bytes_accessed": entry["bytes_accessed"],
                "flops_frac": round(flops_frac, 4),
                "bytes_frac": round(bytes_frac, 4),
                "class": op_class,
            }
        )
    rows.sort(key=lambda r: max(r["flops_frac"], r["bytes_frac"]), reverse=True)
    keep = set(always)
    return rows[:k] + [r for r in rows[k:] if r["op"] in keep]


def count_profile(
    fn: Callable,
    args: tuple = (),
    *,
    name: str,
    peaks: Mapping[str, float],
    collective_bytes: float = 0.0,
    top_k: int = 10,
) -> dict[str, Any] | None:
    """Full profile of one call of ``fn(*args)`` on ``meta`` tensors (the
    counterpart of JAX's ``aot_profile``): the totals, the per-op table
    with every hand-written kernel in it, and the roofline class. The
    ``profile`` command's path. Returns None on any failure."""
    try:
        counter, seconds = _count(fn, args)
    except Exception as exc:  # noqa: BLE001
        logger.warning("cost count of %s failed: %s", name, exc)
        return None
    totals = _totals(counter)
    profile: dict[str, Any] = dict(totals)
    profile["name"] = name
    profile["lower_time_s"] = round(seconds, 4)
    profile["collective_bytes"] = float(collective_bytes)
    profile["top_ops"] = top_ops({"ops": counter.ops, "totals": totals}, peaks, k=top_k,
                                 always=counter.kernels)
    profile["roofline"] = classify_roofline(
        flops=profile["flops"],
        bytes_accessed=profile["bytes_accessed"],
        collective_bytes=profile["collective_bytes"],
        peaks=peaks,
    )
    return profile


def _tensors_of(value: Any) -> Iterable[torch.Tensor]:
    """Tensors held by a module attribute: the tensor itself, or the
    tensors of an object holding some (a quantized weight's codes and
    scales)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif hasattr(value, "__dict__") and not isinstance(value, torch.nn.Module):
        for inner in vars(value).values():
            if isinstance(inner, torch.Tensor):
                yield inner


def meta_module(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose parameters, buffers and tensor attributes
    are storage-free ``meta`` tensors of the same shapes and dtypes (tied
    weights stay tied). The original is not touched and no device memory
    is allocated."""
    memo: dict[int, Any] = {}
    for m in module.modules():
        for p in m._parameters.values():
            if p is not None and id(p) not in memo:
                memo[id(p)] = torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                                 requires_grad=p.requires_grad)
        for b in m._buffers.values():
            if b is not None and id(b) not in memo:
                memo[id(b)] = torch.empty_like(b, device="meta")
        for value in vars(m).values():
            for t in _tensors_of(value):
                if id(t) not in memo:
                    memo[id(t)] = torch.empty_like(t, device="meta")
    return copy.deepcopy(module, memo)


# --------------------------------------------------------------------------
# Roofline classification
# --------------------------------------------------------------------------


def classify_roofline(
    *,
    flops: float,
    bytes_accessed: float,
    peaks: Mapping[str, float],
    collective_bytes: float = 0.0,
) -> dict[str, Any]:
    """Classify one step compute-/memory-/comms-bound.

    The class is the argmax of the three analytical times (flops/peak,
    bytes/hbm_bw, collective_bytes/ici_bw); ``arithmetic_intensity`` vs
    ``ridge_intensity`` (peak_flops/hbm_bw) restates the compute-vs-memory
    half on the classic roofline axes.
    """
    peak_flops = max(float(peaks.get("peak_flops", 1.0)), 1.0)
    hbm_bw = max(float(peaks.get("hbm_bytes_per_sec", 1.0)), 1.0)
    ici_bw = max(float(peaks.get("ici_bytes_per_sec", 1.0)), 1.0)
    compute_ms = flops / peak_flops * 1e3
    memory_ms = bytes_accessed / hbm_bw * 1e3
    comms_ms = collective_bytes / ici_bw * 1e3
    times = {"compute": compute_ms, "memory": memory_ms, "comms": comms_ms}
    bound = max(times, key=lambda key: times[key])
    return {
        "class": bound,
        "analytical_ms": {key: round(val, 6) for key, val in times.items()},
        "arithmetic_intensity": round(flops / max(bytes_accessed, 1.0), 4),
        "ridge_intensity": round(peak_flops / hbm_bw, 4),
    }


def gradient_collective_bytes(
    axis_sizes: Mapping[str, int], trainable_grad_bytes: float
) -> float:
    """Per-device gradient-sync bytes per step: ring all-reduce moves
    ``2*(dp-1)/dp * grad_bytes`` over the combined data-parallel degree
    (the ``data``/``fsdp``/``expert`` axes). 0 when unsharded."""
    dp = 1
    for axis in ("data", "fsdp", "expert"):
        dp *= max(int(axis_sizes.get(axis, 1)), 1)
    if dp <= 1:
        return 0.0
    return 2.0 * (dp - 1) / dp * float(trainable_grad_bytes)


# --------------------------------------------------------------------------
# perf_attribution block (report.json / gauges)
# --------------------------------------------------------------------------

# Documented reconciliation tolerance: analytical(counted)/measured(PaLM-6N)
# MFU ratio outside this band flags a flop-model mismatch in the report.
MFU_RECONCILE_BAND = (0.5, 2.0)


def build_perf_attribution(
    *,
    executables: Iterable[Mapping[str, Any]],
    peaks: Mapping[str, float],
    n_chips: int = 1,
    step_time_ms: float | None = None,
    tokens_per_step: float | None = None,
    palm_flops_per_token: float | None = None,
    measured_mfu: float | None = None,
    collective_bytes: float = 0.0,
    span_totals: Mapping[str, Mapping[str, float]] | None = None,
    steps: int | None = None,
) -> dict[str, Any]:
    """Assemble the ``perf_attribution`` report block.

    ``executables`` are per-step cost dicts from either count; the primary
    (first) one — the train step for a fit — drives the MFU reconciliation
    and the step-time split. All cost figures are PER-DEVICE.
    ``tokens_per_step`` is the global figure; it divides by ``n_chips``
    wherever it meets a cost figure.
    """
    n_chips = max(int(n_chips), 1)
    rows: list[dict[str, Any]] = []
    for exe in executables:
        if not exe:
            continue
        row = dict(exe)
        row.setdefault("collective_bytes", collective_bytes if not rows else 0.0)
        if "roofline" not in row:
            row["roofline"] = classify_roofline(
                flops=row.get("flops", 0.0),
                bytes_accessed=row.get("bytes_accessed", 0.0),
                collective_bytes=row["collective_bytes"],
                peaks=peaks,
            )
        rows.append(row)

    block: dict[str, Any] = {
        "device_kind": peaks.get("device_kind", "unknown"),
        "n_chips": n_chips,
        "peaks": {key: float(peaks.get(key, 0.0)) for key in _PEAK_KEYS},
        "executables": rows,
    }

    primary = rows[0] if rows else None
    if primary is not None and step_time_ms and step_time_ms > 0:
        step_s = step_time_ms / 1e3
        flops_per_chip = primary.get("flops", 0.0)
        analytical_mfu = flops_per_chip / step_s / max(peaks.get("peak_flops", 1.0), 1.0)
        mfu_block: dict[str, Any] = {"analytical": round(analytical_mfu, 6)}
        if measured_mfu is not None:
            mfu_block["measured"] = round(float(measured_mfu), 6)
        if tokens_per_step and palm_flops_per_token:
            # Deterministic form: step time cancels out of the ratio.
            ratio = flops_per_chip / (
                float(tokens_per_step) / n_chips * float(palm_flops_per_token)
            )
            mfu_block["ratio_analytical_over_measured"] = round(ratio, 4)
            lo, hi = MFU_RECONCILE_BAND
            mfu_block["reconciled"] = bool(lo <= ratio <= hi)
            mfu_block["tolerance_band"] = [lo, hi]
        block["mfu"] = mfu_block

        roof = primary.get("roofline") or classify_roofline(
            flops=primary.get("flops", 0.0),
            bytes_accessed=primary.get("bytes_accessed", 0.0),
            collective_bytes=primary.get("collective_bytes", 0.0),
            peaks=peaks,
        )
        analytical = roof.get("analytical_ms", {})
        compute_ms = analytical.get("compute", 0.0)
        comms_ms = analytical.get("comms", 0.0)
        host_ms = 0.0
        if span_totals and steps:
            for span in ("data_wait", "host_dispatch"):
                entry = span_totals.get(span)
                if entry:
                    host_ms += entry.get("total_ms", 0.0) / max(steps, 1)
        gap_ms = max(0.0, step_time_ms - compute_ms - comms_ms - host_ms)
        block["step_time_split_ms"] = {
            "step": round(step_time_ms, 3),
            "analytical_compute": round(compute_ms, 3),
            "analytical_collective": round(comms_ms, 3),
            "measured_host": round(host_ms, 3),
            "unattributed_gap": round(gap_ms, 3),
        }
    return block


def attribution_gauges(block: Mapping[str, Any]) -> dict[str, float]:
    """Flatten a perf_attribution block into ``perf/*`` registry gauges
    (rendered as ``llmtrain_perf_*`` on /metrics)."""
    gauges: dict[str, float] = {}
    rows = block.get("executables") or []
    if rows:
        primary = rows[0]
        gauges["perf/flops_per_step"] = float(primary.get("flops", 0.0))
        gauges["perf/bytes_per_step"] = float(primary.get("bytes_accessed", 0.0))
        gauges["perf/collective_bytes_per_step"] = float(
            primary.get("collective_bytes", 0.0)
        )
        roof = primary.get("roofline") or {}
        gauges["perf/arithmetic_intensity"] = float(
            roof.get("arithmetic_intensity", 0.0)
        )
        classes = {"compute": 0.0, "memory": 1.0, "comms": 2.0}
        gauges["perf/roofline_class"] = classes.get(roof.get("class", ""), -1.0)
    mfu_block = block.get("mfu") or {}
    if "analytical" in mfu_block:
        gauges["perf/mfu_analytical"] = float(mfu_block["analytical"])
    if "ratio_analytical_over_measured" in mfu_block:
        gauges["perf/mfu_reconcile_ratio"] = float(
            mfu_block["ratio_analytical_over_measured"]
        )
    split = block.get("step_time_split_ms") or {}
    for key, value in split.items():
        gauges[f"perf/step_{key}_ms"] = float(value)
    return gauges


def render_top_ops_markdown(rows: Iterable[Mapping[str, Any]]) -> list[str]:
    """Markdown table lines for a top-ops list (report.md / profile CLI)."""
    lines = [
        "| op | count | flops | bytes | flops% | bytes% | class |",
        "|---|---|---|---|---|---|---|",
    ]
    for row in rows:
        lines.append(
            "| {op} | {count} | {flops:.3g} | {bytes_accessed:.3g} "
            "| {fp:.1f}% | {bp:.1f}% | {cls} |".format(
                op=row.get("op", "?"),
                count=row.get("count", 0),
                flops=row.get("flops", 0.0),
                bytes_accessed=row.get("bytes_accessed", 0.0),
                fp=100.0 * row.get("flops_frac", 0.0),
                bp=100.0 * row.get("bytes_frac", 0.0),
                cls=row.get("class", "?"),
            )
        )
    return lines


__all__ = [
    "DEVICE_PEAKS",
    "MFU_RECONCILE_BAND",
    "attribution_gauges",
    "build_perf_attribution",
    "classify_roofline",
    "cost_summary",
    "count_cost_profile",
    "count_profile",
    "gradient_collective_bytes",
    "meta_module",
    "normalize_cost",
    "render_top_ops_markdown",
    "resolve_peaks",
    "top_ops",
]
