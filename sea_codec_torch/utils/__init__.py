from .errors import SeaError

__all__ = ["SeaError"]
