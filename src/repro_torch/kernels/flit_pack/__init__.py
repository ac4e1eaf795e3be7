"""Flit packing / goodput efficiency: kernel.py + ops.py + ref.py."""
