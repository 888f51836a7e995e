from .sit import SIT

__all__ = ['SIT']
