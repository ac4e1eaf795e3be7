"""RG-LRU linear recurrence: kernel.py + ops.py + ref.py."""
