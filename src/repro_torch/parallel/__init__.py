"""Parallelism (counterpart of ``repro.parallel``): logical sharding rules,
the GPipe pipeline schedule."""
