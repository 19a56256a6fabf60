"""Typo detection for the ``extra`` escape hatches (port of
``llmtrain_tpu/config/extras.py``).

The ``extra: dict`` sections stay free-form, but the framework hangs real
knobs off them (loss_impl, z_loss, globs, keep_last_k, ...), so a typo
like ``los_impl`` would silently do nothing. :func:`unknown_extra_keys`
compares each section's keys against what the resolved adapter, data
module and trainer declare (``known_extra_keys``); the CLI prints
warnings, never errors: a plugin may take keys the framework cannot know.
"""

from __future__ import annotations

from .schemas import RunConfig

# Knobs read from trainer.extra (training/trainer.py, training/checkpoint.py,
# training/optimizer.py).
TRAINER_EXTRA_KEYS = frozenset(
    {
        "keep_last_k",
        "profile_start_step",
        "profile_num_steps",
        "profile_all_hosts",
        "optimizer",
        "ema_decay",
        "step_delay_sec",
    }
)


def unknown_extra_keys(cfg: RunConfig) -> dict[str, list[str]]:
    """Best-effort ``{section: sorted unknown keys}`` for warning output.

    Resolves the model adapter (LoRA-augmented) and the data module from
    the registries; a plugin that declares no ``known_extra_keys`` (or an
    unknown name) contributes nothing: this never breaks validation.
    """
    out: dict[str, list[str]] = {}

    def check(section: str, keys, known) -> None:
        if known is None:
            return
        unknown = sorted(set(keys) - set(known))
        if unknown:
            out[section] = unknown

    try:
        from ..models.lora import build_adapter
        from ..registry import initialize_registries

        initialize_registries()
        # The instance, not the class: the LoRA wrapper adds its own key
        # to the wrapped family's (models/lora.py).
        adapter = build_adapter(cfg)
        check("model.extra", cfg.model.extra, getattr(adapter, "known_extra_keys", None))
    except Exception:  # noqa: BLE001 — unknown plugin name etc.: other checks report it
        pass
    try:
        from ..registry import get_data_module

        data_cls = get_data_module(cfg.data.name)
        check("data.extra", cfg.data.extra, getattr(data_cls, "known_extra_keys", None))
    except Exception:  # noqa: BLE001
        pass
    check("trainer.extra", cfg.trainer.extra, TRAINER_EXTRA_KEYS)
    return out


__all__ = ["TRAINER_EXTRA_KEYS", "unknown_extra_keys"]
