from .sharded import ShardedGroupedIndex, query_keep, sharded_count, sharded_count_programs

__all__ = ["ShardedGroupedIndex", "query_keep", "sharded_count", "sharded_count_programs"]
