"""Model configurations of the port (counterpart of ``repro/configs``)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    get_config,
    list_archs,
    list_configs,
    register,
)
