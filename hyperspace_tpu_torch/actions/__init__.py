from . import states  # noqa: F401
