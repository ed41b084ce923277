"""Engine: topology planning, banded-operator builders and streaming."""

from .plan import (EnginePlan, EngineConfigError, plan_engine,
                   plan_from_arrays, MIN_RATIO, MAX_RATIO)
from .counts import LengthModel
from .streaming import EngineCore

__all__ = [
    "EnginePlan", "EngineConfigError", "plan_engine", "plan_from_arrays",
    "MIN_RATIO", "MAX_RATIO", "LengthModel", "EngineCore",
]
