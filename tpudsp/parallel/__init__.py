"""Mesh / sharding / halo-exchange runtime (the new L-1 layer with no
counterpart in the reference; SURVEY.md section 1)."""

from .mesh import CHANNEL_AXIS, TIME_AXIS, bank_sharding, make_mesh, replicated
from .am import ShardedAMReceiver

__all__ = [
    "CHANNEL_AXIS", "TIME_AXIS", "bank_sharding", "make_mesh", "replicated",
    "ShardedAMReceiver",
    # heavier runtimes import from their modules directly:
    #   .bank.ShardedBank, .channelizer.{ShardedChannelizer,
    #   ShardedChannelizedBank}, .pipeline (PP), .elastic.ElasticRunner
]
