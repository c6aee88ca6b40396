from . import ntt  # noqa: F401
