"""Deployment sizing: the production and debug meshes (`mesh.py`)."""
