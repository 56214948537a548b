from .api import Model, build_model, text_len, value_and_grad

__all__ = ["Model", "build_model", "text_len", "value_and_grad"]
