"""Snoop-filter protocol scan: kernel.py + ops.py + ref.py."""
