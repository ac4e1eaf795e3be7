"""Segmented (max,+) depart scan: kernel.py + ops.py + ref.py."""
