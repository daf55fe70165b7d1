"""Scenario batching (mesh.py) and sharding across processes, one per card
(distributed.py)."""
