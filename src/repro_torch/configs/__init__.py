from repro_torch.configs.base import ModelConfig, get_config, get_smoke_config

__all__ = ["ModelConfig", "get_config", "get_smoke_config"]
