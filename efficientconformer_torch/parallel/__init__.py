"""Data parallelism over GPUs (parallel/mesh.py)."""
