"""The multi-label degradation classifier (inference and its checkpoints)."""
