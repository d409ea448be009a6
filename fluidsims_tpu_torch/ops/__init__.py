from . import euler2d, limiters, riemann, sdf, weno  # noqa: F401
