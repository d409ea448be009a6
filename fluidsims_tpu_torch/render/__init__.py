"""Terminal renderers of the port (NumPy only): `points`, the graph
layouts' point clouds."""
