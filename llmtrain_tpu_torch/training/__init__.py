"""Training-side modules: the optimizer, the train and eval steps, the
trainer, the forward-only dry run, and checkpoints (read and write)."""
