"""The serving runtime (counterpart of ``repro.runtime``): the slot server."""
