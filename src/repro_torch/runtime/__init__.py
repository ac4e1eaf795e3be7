"""The runtime (counterpart of ``repro.runtime``): the slot server, the
trainer and the straggler policy."""
