from repro_torch.configs.base import (
    ARCH_IDS,
    PORTED_ARCHS,
    ModelConfig,
    ServeConfig,
    TrainConfig,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ARCH_IDS",
    "PORTED_ARCHS",
    "ModelConfig",
    "ServeConfig",
    "TrainConfig",
    "get_config",
    "get_smoke_config",
]
