from .base import (LONG_CONTEXT_OK, SHAPES, ModelConfig,  # noqa: F401
                   ShapeConfig, all_archs, cells, get_config)
from .archs import reduced  # noqa: F401
