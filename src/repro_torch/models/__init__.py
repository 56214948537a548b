from .api import (Model, build_model, cache_specs, input_specs,
                  params_specs, text_len, value_and_grad)

__all__ = ["Model", "build_model", "cache_specs", "input_specs",
           "params_specs", "text_len", "value_and_grad"]
