"""Row-sharded solving over a mesh of shards driven by one process."""
