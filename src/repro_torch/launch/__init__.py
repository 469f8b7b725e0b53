"""Deployment sizing: the production and debug meshes (`mesh.py`) and the
kernels' analytic roofline on the H100 (`roofline.py`)."""
