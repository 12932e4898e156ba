"""Mesh-parallel execution across devices (parallel/mesh.py)."""
