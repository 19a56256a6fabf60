"""Mesh planning and auto-tuning (port of ``llmtrain_tpu/autotune/``):
:mod:`.plan` (the validated layout and its memory model), :mod:`.search`
(candidates and the analytic pruning) and :mod:`.tune` (the probe fits)."""
