"""Architecture registry: `--arch <id>` resolves here."""
from .archs import ARCHS, reduced
from .base import (SHAPES, SHAPES_BY_NAME, MLAConfig, MoEConfig, ModelConfig,
                   ShapeConfig, SSMConfig)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


__all__ = ["ARCHS", "SHAPES", "SHAPES_BY_NAME", "MLAConfig", "MoEConfig",
           "ModelConfig", "SSMConfig", "ShapeConfig", "get_config",
           "list_archs", "reduced"]
