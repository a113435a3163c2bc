from .driver import Walker

__all__ = ["Walker"]
