"""The model stack's serving path (counterpart of ``repro.models``): layers,
the RG-LRU and attention blocks, the block stack, weight conversion."""
