"""Opaque page handles: the virtual-addressing API boundary (DESIGN.md §11).

Callers that *hold* pages — ``Request.kv_pages``, the sharded pool's
alloc/free/move surfaces, migration planner inputs — hold
:class:`PageRef` handles, not raw physical slot indices. A ``PageRef``
names a *virtual* page id plus the page-table generation it was minted
under; the owning pool's :class:`repro_torch.mmu.PageTable` translates it to a
(shard, physical slot) pair at touch time. Remap-based defragmentation
and ownership-first migration change that translation without invalidating
the handle's identity.

Compatibility bridge (one release, mirroring the ``SubmitRequest``
migration):``PageRef`` subclasses ``int`` so every legacy consumer that
treats a page id as an index keeps working bit-for-bit while call sites
migrate, and :func:`as_pageref` coerces a bare ``int`` argument with a
``DeprecationWarning``. The int-ness is NOT part of the contract — new
code must treat the handle as opaque (``tools/lint_pageref_api.py``
hard-fails new internal bare-int call sites) — and is removed one release
after 0.8.
"""
from __future__ import annotations

import numbers
import warnings
from typing import Iterable, List, Sequence, Union

__all__ = ["PageRef", "PageRefLike", "as_pageref", "as_pagerefs", "vpage"]


class PageRef(int):
    """Opaque handle to one virtual page.

    ``vpage`` is the virtual page id (== the integer value, during the
    compatibility bridge); ``generation`` is the page-table generation the
    handle was minted under — a stale handle still resolves (virtual ids
    are stable across remaps), the generation exists so tooling can tell
    *when* a handle predates a remap.
    """

    # (int subclasses cannot carry nonempty __slots__; the instance dict
    # holds only `generation`.)

    def __new__(cls, vpage: int, generation: int = 0) -> "PageRef":
        self = super().__new__(cls, int(vpage))
        self.generation = int(generation)
        return self

    @property
    def vpage(self) -> int:
        return int(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"PageRef({int(self)}, gen={self.generation})"


PageRefLike = Union[PageRef, int]


def _warn_bare_int(api: str) -> None:
    warnings.warn(
        f"{api}: bare int page ids are deprecated; pass PageRef handles "
        "(returned by the pool's alloc/defragment/flip surfaces). The int "
        "form is removed one release after 0.8.",
        DeprecationWarning, stacklevel=4)


def as_pageref(value: PageRefLike, *, api: str = "page API") -> PageRef:
    """Coerce one page argument to a :class:`PageRef`.

    A bare integer (including numpy scalars — legacy plumbing passed
    those) coerces with a one-release ``DeprecationWarning``.
    """
    if isinstance(value, PageRef):
        return value
    if isinstance(value, numbers.Integral):
        _warn_bare_int(api)
        return PageRef(int(value))
    raise TypeError(f"{api}: expected a PageRef or int page id, "
                    f"got {value!r}")


def as_pagerefs(values: Iterable[PageRefLike], *,
                api: str = "page API") -> List[PageRef]:
    """Coerce a page list; one warning covers the whole list."""
    out: List[PageRef] = []
    warned = False
    for v in values:
        if isinstance(v, PageRef):
            out.append(v)
        elif isinstance(v, numbers.Integral):
            if not warned:
                _warn_bare_int(api)
                warned = True
            out.append(PageRef(int(v)))
        else:
            raise TypeError(f"{api}: expected PageRef or int page ids, "
                            f"got {v!r}")
    return out


def vpage(value: PageRefLike) -> int:
    """The virtual page id behind a handle (internal unwrap helper)."""
    return int(value)


def vpages(values: Sequence[PageRefLike]) -> List[int]:
    """Unwrap a handle list to virtual ids (internal helper)."""
    return [int(v) for v in values]
