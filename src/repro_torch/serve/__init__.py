"""Serving substrate: the paged KV cache."""
from .kv_cache import OutOfPages, PageAllocator, PagedKVCache  # noqa: F401
