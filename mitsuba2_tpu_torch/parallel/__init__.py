"""Long-run and multi-device support: checkpoint and resume
(checkpoint.py), rendering over a mesh of devices (mesh.py)."""
