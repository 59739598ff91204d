from .base import SHAPES, ModelConfig, ShapeSpec, cells_for
from .registry import ARCHS, build_model, get_config, reduced
