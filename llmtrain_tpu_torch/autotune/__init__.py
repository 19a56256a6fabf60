"""Mesh planning (port of the part of ``llmtrain_tpu/autotune/`` the
trainer calls: :mod:`.plan`). The HBM model, the search and the tuner
are not ported yet (ROADMAP.md queue A: autotune)."""
