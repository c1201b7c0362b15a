"""Sharded programs over a mesh of logical shards (see `mesh.py`)."""
