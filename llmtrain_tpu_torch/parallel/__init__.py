"""Parallelism on the port's process group (port of ``llmtrain_tpu/parallel``):
the ZeRO partition rule and host memory (sharding.py), and the sharded
optimizer state's collectives (zero.py)."""
