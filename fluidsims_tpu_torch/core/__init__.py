from . import clock, config, device, stepper  # noqa: F401
