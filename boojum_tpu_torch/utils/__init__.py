from . import npgl  # noqa: F401
