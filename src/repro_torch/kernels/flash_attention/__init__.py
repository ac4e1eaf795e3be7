"""Causal / sliding-window GQA flash attention: kernel.py + ops.py + ref.py."""
