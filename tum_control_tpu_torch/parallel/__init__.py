"""Scenario batching (multi-GPU sharding waits for its slice)."""
