"""speedyml: JAX hybrid climate modeling framework (SPEEDY + reservoirs).

Public API (see README.md; full parity map in PARITY.md):

  Speedy                       full-physics T30L8 atmosphere model
  Dycore                       dry spectral dynamical core
  ModelConfig / ReservoirConfig / HybridConfig
  build_layout                 region decomposition + gather maps
  train_hybrid / HybridModel / HybridRunner
  SpeedyForecaster / TrajectoryRunner
  train_ocean / OceanModel     slab-ocean reservoir
  save_model / load_model      trained-weight persistence
"""

from .core.config import HybridConfig, ModelConfig, ReservoirConfig


def __getattr__(name):
    # heavyweight members resolve lazily so `import speedyml` stays cheap
    lazy = {
        "Speedy": ("speedyml.model", "Speedy"),
        "Dycore": ("speedyml.dynamics.core", "Dycore"),
        "build_layout": ("speedyml.domain.decomposition", "build_layout"),
        "train_hybrid": ("speedyml.hybrid.experiment", "train_hybrid"),
        "HybridModel": ("speedyml.hybrid.experiment", "HybridModel"),
        "HybridRunner": ("speedyml.hybrid.experiment", "HybridRunner"),
        "SpeedyForecaster": ("speedyml.hybrid.forecast", "SpeedyForecaster"),
        "TrajectoryRunner": ("speedyml.hybrid.forecast", "TrajectoryRunner"),
        "train_ocean": ("speedyml.reservoir.slab", "train_ocean"),
        "OceanModel": ("speedyml.reservoir.slab", "OceanModel"),
        "save_model": ("speedyml.io.weights", "save_model"),
        "load_model": ("speedyml.io.weights", "load_model"),
        "analysis": ("speedyml.utils", "analysis"),
    }
    if name in lazy:
        import importlib
        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'speedyml' has no attribute {name!r}")


__all__ = ["HybridConfig", "ModelConfig", "ReservoirConfig", "Speedy",
           "Dycore", "build_layout", "train_hybrid", "HybridModel",
           "HybridRunner", "SpeedyForecaster", "TrajectoryRunner",
           "train_ocean", "OceanModel", "save_model", "load_model", "analysis"]
