"""File formats of the port: its own copies of the JAX package's numpy-only
I/O modules, so the port imports nothing of `fluidsims_tpu`."""
