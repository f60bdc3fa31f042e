from repro_torch.configs.base import (  # noqa: F401
    ASSIGNED_ARCHS,
    PAPER_ARCHS,
    SHAPES,
    EngineConfig,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_configs,
    register,
    shape_applicable,
)
