from .ava import AvaBuilder, AvaStrategy
from .twoset import TwoSetBuilder, TwoSetStrategy

__all__ = ["AvaBuilder", "AvaStrategy", "TwoSetBuilder", "TwoSetStrategy"]
