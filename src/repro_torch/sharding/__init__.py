"""Sharding: partition-spec rules for params, optimizer state, batches and
caches, and their DTensor placements."""
