from .twoset import TwoSetBuilder, TwoSetStrategy

__all__ = ["TwoSetBuilder", "TwoSetStrategy"]
