"""Data pipeline substrate."""
from .pipeline import (  # noqa: F401
    DataConfig,
    DataIterator,
    IteratorState,
    make_batch,
    mesh_hosts,
    pack_documents,
)
