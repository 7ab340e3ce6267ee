from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    XLSTMConfig,
    get_config,
    get_smoke_config,
    registry,
    supports_shape,
)

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig", "MoEConfig", "SSMConfig",
           "XLSTMConfig", "get_config", "get_smoke_config", "registry", "supports_shape"]
