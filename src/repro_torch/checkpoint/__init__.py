"""Checkpointing (counterpart of ``repro.checkpoint``): atomic, hashed,
async."""
