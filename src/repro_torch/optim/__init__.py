from .sgd import update_norm

__all__ = ["update_norm"]
