"""Serve-round (max,+) affine-map scan: kernel.py + ops.py + ref.py."""
