"""Optimizers (counterpart of ``repro.optim``): AdamW with float32 master
weights, LR schedules, gradient compression."""
