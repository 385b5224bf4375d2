"""Runtime configuration and device resolution."""

from .config import _env, _env_bool, _env_int  # noqa: F401
from .device import resolve_device  # noqa: F401
