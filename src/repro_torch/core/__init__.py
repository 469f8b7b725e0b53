"""The flat index and its search, on torch tensors.

As `repro.core` does, the package answers the deprecated
`make_sharded_search` of the README's migration table, imported at first
use (the search imports the kernels, which import `core.isax`).  The
deprecated `search` is `core.search.search`: here `core.search` names
the search module."""


def __getattr__(name):
    if name == "make_sharded_search":
        from .search import make_sharded_search
        return make_sharded_search
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
