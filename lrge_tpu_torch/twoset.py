"""Namespace mirror of ``liblrge::twoset`` (Builder + defaults), as
``lrge_tpu/twoset.py`` gives it, over the port's strategy."""

from .strategy.twoset import (
    DEFAULT_QUERY_NUM_READS,
    DEFAULT_TARGET_NUM_READS,
    TwoSetBuilder as Builder,
    TwoSetStrategy,
)

__all__ = [
    "Builder",
    "TwoSetStrategy",
    "DEFAULT_TARGET_NUM_READS",
    "DEFAULT_QUERY_NUM_READS",
]
