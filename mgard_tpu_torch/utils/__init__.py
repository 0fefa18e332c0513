from .log import Timer, log  # noqa: F401
