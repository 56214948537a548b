from .base import (ModelConfig, MoEConfig, MLAConfig, MambaConfig, RWKVConfig,
                   EncoderConfig, get_config, list_configs, register)

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "MambaConfig", "RWKVConfig",
    "EncoderConfig", "get_config", "list_configs", "register",
]
