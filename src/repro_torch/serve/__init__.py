"""Serving substrate: paged KV cache + continuous batching engine."""
from .engine import Request, ServeEngine  # noqa: F401
from .kv_cache import OutOfPages, PageAllocator, PagedKVCache  # noqa: F401
