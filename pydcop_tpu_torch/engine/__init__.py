"""The batched engine."""
