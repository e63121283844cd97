"""Multi-process page transport (ports ``repro/serve/net``): the
``PageTransport`` seam over real sockets.  ``framing`` defines the
length-prefixed frame layer and control protocol, ``client`` the sender
(``SocketTransport``) and the driver-side decode proxy
(``RemoteDecodeReplica``), ``server`` the decode host's session handler
(``PageHost``).  The process entry points live in
``repro_torch.launch.disagg_host``; the payloads are specified in
``repro_torch.serve.transport``.  Pure host code: the same frames and
bytes as the reference's."""
from . import framing  # noqa: F401
from .client import RemoteDecodeReplica, SocketTransport  # noqa: F401
from .server import PageHost  # noqa: F401
