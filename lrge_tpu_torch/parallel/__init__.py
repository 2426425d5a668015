from .sharded import ShardedGroupedIndex, query_keep, sharded_count

__all__ = ["ShardedGroupedIndex", "query_keep", "sharded_count"]
