from .base import ModelConfig
from .registry import ARCHS, build_model, get_config, reduced
