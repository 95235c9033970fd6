from .registry import available_models, load_params
from .schema import HeliParams, precalculate

__all__ = ["HeliParams", "available_models", "load_params", "precalculate"]
