"""Data pipeline substrate."""
from .pipeline import (  # noqa: F401
    DataConfig,
    DataIterator,
    IteratorState,
    make_batch,
    pack_documents,
)
