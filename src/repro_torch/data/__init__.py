"""Data pipelines (counterpart of ``repro.data``): the deterministic
synthetic LM source and the ESF trace-replay source."""
