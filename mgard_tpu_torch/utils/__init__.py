from .log import log  # noqa: F401
