"""The runtime (counterpart of ``repro.runtime``): the slot server and the
straggler policy."""
