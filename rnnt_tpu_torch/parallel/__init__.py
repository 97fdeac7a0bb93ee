"""Multi-rank training: the process mesh and its collectives (mesh.py)."""
