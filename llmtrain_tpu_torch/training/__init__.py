"""Training-side modules; this slice ports the checkpoint read side only."""
