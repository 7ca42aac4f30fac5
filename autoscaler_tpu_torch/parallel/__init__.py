"""Device meshes for the what-if and fleet dispatches (``mesh.py``)."""
