from .registry import available_models, load_params, register_model_path
from .schema import (EnvPhysics, Fuselage, HeliBody, HeliParams, HorizontalTail,
                     LandingGear, MainRotor, TailRotor, VerticalTail, Wing,
                     precalculate)

__all__ = ["EnvPhysics", "Fuselage", "HeliBody", "HeliParams", "HorizontalTail",
           "LandingGear", "MainRotor", "TailRotor", "VerticalTail", "Wing",
           "available_models", "load_params", "precalculate", "register_model_path"]
