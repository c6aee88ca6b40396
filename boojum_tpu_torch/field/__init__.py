from . import extension, goldilocks  # noqa: F401
from .goldilocks import ORDER  # noqa: F401
