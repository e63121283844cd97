"""Serving: prefill and slot-based decode over the paged LEXI-compressed
cache (``engine``) and the continuous-batching loop (``scheduler``)."""
from . import engine  # noqa: F401
from .scheduler import (Request, RequestResult, RequestScheduler,  # noqa: F401
                        ServeEngine, ServeStats)
