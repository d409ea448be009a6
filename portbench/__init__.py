"""The benchmark of fluidsims_tpu_torch on the card (README.md)."""
