"""Renderers of the port: `points` (the graph layouts' point clouds),
`terminal` and `colormap` (NumPy copies of the JAX package's), and `views`
(the flagship's view modes, in torch on the state's device)."""
