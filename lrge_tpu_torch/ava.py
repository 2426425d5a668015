"""Namespace mirror of ``liblrge::ava`` (Builder + defaults), as
``lrge_tpu/ava.py`` gives it, over the port's strategy."""

from .strategy.ava import AvaStrategy, DEFAULT_AVA_NUM_READS, AvaBuilder as Builder

__all__ = ["Builder", "AvaStrategy", "DEFAULT_AVA_NUM_READS"]
