from . import euler2d, limiters, riemann, sdf  # noqa: F401
