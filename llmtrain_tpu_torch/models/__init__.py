"""Model families ported to PyTorch (this slice: the dense GPT)."""
