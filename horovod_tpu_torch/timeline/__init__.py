"""Host-side spans and the metrics registry the serving path feeds."""

from .metrics import registry, reset_metrics  # noqa: F401
from .spans import recorder  # noqa: F401
