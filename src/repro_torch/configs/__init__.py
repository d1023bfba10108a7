from .base import (LayerSpec, MLAConfig, ModelConfig, MoEConfig, RGLRUConfig,
                   SHAPES, SSMConfig, ShapeConfig)
from .registry import (ARCHS, LONG_OK, all_cells, cells, get_config,
                       get_shape, list_archs, smoke_config)

__all__ = ["LayerSpec", "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig",
           "SHAPES", "SSMConfig", "ShapeConfig", "ARCHS", "LONG_OK",
           "all_cells", "cells", "get_config", "get_shape", "list_archs",
           "smoke_config"]
