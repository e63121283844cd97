"""Serving: prefill and slot-based decode over the paged LEXI-compressed
cache (``engine``), the continuous-batching loop (``scheduler``), and its
prefix sharing: content keys (``digest``), page payloads and the digest
store (``transport``), the tiered page retention (``pagecache``)."""
from . import engine  # noqa: F401
from .pagecache import PageCache  # noqa: F401
from .scheduler import (Request, RequestResult, RequestScheduler,  # noqa: F401
                        ServeEngine, ServeStats)
