from .ava import DEFAULT_AVA_NUM_READS, AvaBuilder, AvaStrategy
from .twoset import DEFAULT_QUERY_NUM_READS, DEFAULT_TARGET_NUM_READS, TwoSetBuilder, TwoSetStrategy

__all__ = [
    "AvaBuilder",
    "AvaStrategy",
    "DEFAULT_AVA_NUM_READS",
    "TwoSetBuilder",
    "TwoSetStrategy",
    "DEFAULT_TARGET_NUM_READS",
    "DEFAULT_QUERY_NUM_READS",
]
