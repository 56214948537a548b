from .base import (ModelConfig, MoEConfig, MLAConfig, MambaConfig, RWKVConfig,
                   EncoderConfig, get_config, list_configs, register)
from .shapes import SHAPES, ShapeConfig, all_cells, applicable, get_shape

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "MambaConfig", "RWKVConfig",
    "EncoderConfig", "get_config", "list_configs", "register",
    "SHAPES", "ShapeConfig", "all_cells", "applicable", "get_shape",
]
