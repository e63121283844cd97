"""Serving: prefill and slot-based decode over the paged LEXI-compressed
cache (``engine``), the continuous-batching loop (``scheduler``), its
prefix sharing (content keys in ``digest``, the tiered page retention in
``pagecache``), disaggregated prefill -> decode replicas over compressed
page transfer (``disagg`` routing, ``transport`` wire format and digest
stores, ``net`` the socket transport between OS processes), and
``telemetry`` (request-lifecycle tracing, the metrics registry)."""
from . import engine  # noqa: F401
from .scheduler import (Request, RequestResult, RequestScheduler,  # noqa: F401
                        ServeEngine, ServeStats)
from .pagecache import PageCache  # noqa: F401
from .disagg import (DecodeReplica, DisaggEngine, DisaggStats,  # noqa: F401
                     PrefillReplica)
from .transport import (DigestStore, LoopbackTransport,  # noqa: F401
                        PageTransport, SequenceBlob, TransportStats)
from .net import (PageHost, RemoteDecodeReplica,  # noqa: F401
                  SocketTransport)
from .telemetry import (MetricsRegistry, Tracer,  # noqa: F401
                        summarize_latencies)
