from .api import Model, build_model, value_and_grad

__all__ = ["Model", "build_model", "value_and_grad"]
