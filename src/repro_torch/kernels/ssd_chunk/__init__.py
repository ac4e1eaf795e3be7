"""Mamba-2 SSD chunk scan: kernel.py + ops.py + ref.py."""
