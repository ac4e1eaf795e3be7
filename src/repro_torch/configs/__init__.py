"""Architecture registry: ``--arch <id>`` -> (full config, smoke config).

The counterpart of ``repro/configs/__init__.py``, over the port's copies of
the config modules."""

from __future__ import annotations

import importlib

from .base import ArchConfig, MoESpec, ShapeSpec, SHAPES, shape_applicable  # noqa: F401

ARCH_MODULES = {
    "granite-20b": "granite_20b",
    "llama3-8b": "llama3_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "grok-1-314b": "grok_1_314b",
    "whisper-base": "whisper_base",
    "mamba2-1.3b": "mamba2_1_3b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}

ARCH_IDS = tuple(ARCH_MODULES)


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.SMOKE
