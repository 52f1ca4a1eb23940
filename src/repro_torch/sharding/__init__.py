"""Partition specs for the production layouts and the activation hooks
the models call (the port of the reference ``repro/sharding``)."""

from .specs import (NamedSharding, PartitionSpec, ShardingRules, abstract_mesh,
                    cache_shard_bytes, fit_spec, leaf_shard_bytes,
                    named_leaves, shard_bytes, shard_shape)

__all__ = ["NamedSharding", "PartitionSpec", "ShardingRules", "abstract_mesh",
           "cache_shard_bytes", "fit_spec", "leaf_shard_bytes",
           "named_leaves", "shard_bytes", "shard_shape"]
