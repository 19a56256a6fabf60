"""Tokenizers (the data pipeline itself comes with the training slice)."""
