from . import lightgcn

__all__ = ["lightgcn"]
