"""Input pipeline: the device prefetcher (``horovod_tpu/data``)."""

from .prefetch import DevicePrefetcher, prefetch_to_device  # noqa: F401

__all__ = ["DevicePrefetcher", "prefetch_to_device"]
