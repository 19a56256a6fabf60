"""Ops of the port: the hand-written CUDA kernels, their plain versions, and RoPE."""
