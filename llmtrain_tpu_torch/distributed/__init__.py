"""Device selection and the multi-process runtime for the port's entry
points (port of ``llmtrain_tpu/distributed/__init__.py``).

Device: ``run.device: "cpu"`` runs on the CPU; ``"tpu"`` (the value the
existing presets carry) and ``"cuda"`` run on the card (``configure_platform``
of the JAX package). When the card is asked for and none is visible the
entry point raises — it never continues on the CPU.

Multi-process: :func:`setup_distributed` resolves the topology env-first as
JAX does (``JAX_NUM_PROCESSES``/``WORLD_SIZE``, ``JAX_PROCESS_ID``/``RANK``,
``JAX_COORDINATOR_ADDRESS``, then ``MASTER_ADDR``/``MASTER_PORT``, then the
config) and joins a ``torch.distributed`` process group over a TCP
rendezvous at the coordinator: **NCCL when the run's device is the card,
gloo when it is the CPU**, and no fallback from one to the other.
``distributed.backend`` keeps JAX's ``"jax"`` value; the backend follows
``run.device``. A rank's card is ``cuda:LOCAL_RANK`` (default 0). A
one-process run still forms a group (over an in-memory store, no socket),
so its gradient all-reduce is a real NCCL or gloo call. JAX's TPU
pod-slice auto-detection (GKE's ``TPU_WORKER_HOSTNAMES``) has no GPU
counterpart and is not ported.

The collectives (:func:`allgather_any`, :func:`allgather_scalar`,
:func:`broadcast_int_from_main`) are the identity on one process. A
collective that times out raises :class:`TimeoutError` and one whose peer
went away :class:`ConnectionError`, so the CLI's exit-code walk gives 75
(a transient fault) as it does for JAX's rendezvous.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta
from typing import Iterator

import torch

from ..config.schemas import DistributedConfig
from ..utils.logging import get_logger

_DEFAULT_COORDINATOR_PORT = 29500

# Module-level idempotency latch, as in the JAX package.
_ACTIVE_STATE: "DistState | None" = None
_GROUP_OWNED = False


def resolve_device(device: str) -> torch.device:
    """``run.device`` → the torch device an entry point runs on (the
    current card: ``cuda:LOCAL_RANK`` once :func:`setup_distributed` ran)."""
    if device == "cpu":
        return torch.device("cpu")
    if device in ("tpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"run.device is {device!r}, which runs on the card, but "
                "torch.cuda.is_available() is False; set run.device: \"cpu\" "
                "to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown run.device {device!r}; expected cpu, tpu or cuda")


@dataclass(frozen=True)
class DistState:
    """Resolved multi-process topology for this process (the JAX
    ``DistState``): ``is_main`` gates all filesystem I/O."""

    process_index: int
    num_processes: int
    local_device_count: int
    is_main: bool
    coordinator: str | None = None
    backend: str | None = None

    def __post_init__(self) -> None:
        if self.num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if not (0 <= self.process_index < self.num_processes):
            raise ValueError("process_index must be in [0, num_processes)")
        if self.is_main != (self.process_index == 0):
            raise ValueError("is_main must equal (process_index == 0)")

    @property
    def rank(self) -> int:
        return self.process_index

    @property
    def world_size(self) -> int:
        return self.num_processes


def _env_int(*names: str) -> int | None:
    for name in names:
        raw = os.environ.get(name)
        if raw is not None and raw != "":
            try:
                return int(raw)
            except ValueError as exc:
                raise ValueError(f"Environment variable {name}={raw!r} is not an integer") from exc
    return None


def _resolve_int(env_names: tuple[str, ...], config_value: int | None, default: int) -> int:
    env_val = _env_int(*env_names)
    if env_val is not None:
        return env_val
    if config_value is not None:
        return config_value
    return default


def resolve_topology(cfg: DistributedConfig) -> tuple[int, int, str | None]:
    """(process_id, num_processes, coordinator), env-first: JAX-native env
    names beat torch-style names beat config values beat defaults."""
    num_processes = _resolve_int(("JAX_NUM_PROCESSES", "WORLD_SIZE"), cfg.num_processes, 1)
    explicit_process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if explicit_process_id is None:
        explicit_process_id = cfg.process_id
    if explicit_process_id is None and num_processes > 1:
        # Fail fast instead of letting every process claim rank 0 and hang
        # in the rendezvous until the timeout.
        raise ValueError(
            "Multi-process run (num_processes "
            f"= {num_processes}) but process id is unset; set RANK/JAX_PROCESS_ID "
            "or distributed.process_id"
        )
    process_id = explicit_process_id if explicit_process_id is not None else 0

    # "" counts as unset for the address, as in _env_int.
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS") or None
    if coordinator is None:
        addr = os.environ.get("MASTER_ADDR") or cfg.coordinator_addr
        port = _resolve_int(("MASTER_PORT",), cfg.coordinator_port, _DEFAULT_COORDINATOR_PORT)
        coordinator = f"{addr}:{port}" if addr else None
    return process_id, num_processes, coordinator


def _local_card(device: str) -> int | None:
    """The card index of this rank (``LOCAL_RANK``, default 0), checked
    against the visible cards; None on the CPU."""
    if device == "cpu":
        return None
    resolve_device(device)  # raises when no card is visible
    local = _env_int("LOCAL_RANK")
    local = 0 if local is None else local
    count = torch.cuda.device_count()
    if not 0 <= local < count:
        raise ValueError(
            f"LOCAL_RANK={local} but {count} card(s) are visible; each rank "
            "needs a card of its own"
        )
    return local


def setup_distributed(cfg: DistributedConfig, device: str = "cuda") -> DistState:
    """Join the process group (idempotent: a second call warns and returns
    the existing state). ``device`` is ``run.device``: the card gives NCCL,
    the CPU gloo. Raises ``ValueError`` for a topology that cannot work
    (no process id, no coordinator, a ``LOCAL_RANK`` past the cards) and
    lets a rendezvous failure (the coordinator not up, a timeout) through
    for the caller's retry."""
    global _ACTIVE_STATE, _GROUP_OWNED
    logger = get_logger()
    if _ACTIVE_STATE is not None:
        logger.warning("distributed runtime already initialized; returning existing state")
        return _ACTIVE_STATE

    process_id, num_processes, coordinator = resolve_topology(cfg)
    if num_processes > 1 and coordinator is None:
        raise ValueError(
            "Multi-process run requires a coordinator address "
            "(set MASTER_ADDR/MASTER_PORT, JAX_COORDINATOR_ADDRESS, "
            "or distributed.coordinator_addr/coordinator_port)"
        )
    card = _local_card(device)
    backend = "gloo" if card is None else "nccl"
    if card is not None:
        torch.cuda.set_device(card)
    import torch.distributed as dist

    timeout = timedelta(seconds=cfg.timeout_sec)
    if num_processes == 1 and coordinator is None:
        # One process: an in-memory store, no socket to rendezvous on.
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                rank=process_id, world_size=num_processes, timeout=timeout)
    _GROUP_OWNED = True
    state = DistState(
        process_index=dist.get_rank(),
        num_processes=dist.get_world_size(),
        local_device_count=1 if card is None else torch.cuda.device_count(),
        is_main=dist.get_rank() == 0,
        coordinator=coordinator,
        backend=backend,
    )
    _ACTIVE_STATE = state
    logger.info(
        "distributed runtime ready: process %d/%d over %s, %d local device(s)",
        state.process_index, state.num_processes, backend, state.local_device_count,
    )
    return state


def teardown_distributed() -> None:
    """Leave the process group if this module formed it."""
    global _ACTIVE_STATE, _GROUP_OWNED
    if _GROUP_OWNED:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        _GROUP_OWNED = False
    _ACTIVE_STATE = None


def active_state() -> DistState | None:
    return _ACTIVE_STATE


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL, the
    CPU under gloo."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# Host seconds this process spent inside collective calls (blocked waiting
# for its peers, on gloo), for the straggler telemetry's net step time.
_COLLECTIVE_WAIT_SEC = [0.0]


def collective_wait_seconds() -> float:
    """Host seconds spent inside collective calls so far (process-wide)."""
    return _COLLECTIVE_WAIT_SEC[0]


@contextmanager
def collective_errors() -> Iterator[None]:
    """Re-raise a collective's timeout as :class:`TimeoutError` and a lost
    peer as :class:`ConnectionError` (exit 75 in the CLI's walk). The time
    inside adds to :func:`collective_wait_seconds`."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    try:
        yield
    except (dist.DistError, RuntimeError) as exc:
        text = str(exc).lower()
        if "timed out" in text or "timeout" in text:
            raise TimeoutError(f"collective timed out: {exc}") from exc
        if any(s in text for s in ("closed by peer", "reset by peer", "connection refused",
                                   "broken pipe")):
            raise ConnectionError(f"collective lost a peer: {exc}") from exc
        raise
    finally:
        _COLLECTIVE_WAIT_SEC[0] += time.perf_counter() - t0


def allgather_any(flag: bool) -> bool:
    """Cross-process OR of a local boolean (collective: every process must
    call it at the same point). Single process: the identity."""
    if _world() == 1:
        return bool(flag)
    import torch.distributed as dist

    t = torch.tensor([1 if flag else 0], dtype=torch.int64, device=_collective_device())
    with collective_errors():
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def allgather_scalar(value: float) -> list[float]:
    """Per-process list of a local scalar, indexed by process id
    (collective). Single process: a one-element list."""
    world = _world()
    if world == 1:
        return [float(value)]
    import torch.distributed as dist

    device = _collective_device()
    local = torch.tensor([float(value)], dtype=torch.float64, device=device)
    out = torch.empty(world, dtype=torch.float64, device=device)
    with collective_errors():
        dist.all_gather_into_tensor(out, local)
    return [float(x) for x in out.cpu()]


def broadcast_int_from_main(value: int) -> int:
    """Process 0's value on every process (collective). Single process:
    the identity."""
    if _world() == 1:
        return int(value)
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64, device=_collective_device())
    with collective_errors():
        dist.broadcast(t, src=0)
    return int(t.item())


def barrier() -> None:
    """Every process waits here for the others (single process: returns)."""
    if _world() == 1:
        return
    allgather_any(False)


__all__ = [
    "DistState",
    "active_state",
    "allgather_any",
    "allgather_scalar",
    "barrier",
    "broadcast_int_from_main",
    "collective_errors",
    "collective_wait_seconds",
    "resolve_device",
    "resolve_topology",
    "setup_distributed",
    "teardown_distributed",
]
