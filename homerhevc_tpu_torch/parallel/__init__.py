"""Scale-out over several devices (mesh.py)."""
