"""Kernel workspaces that a CUDA graph can hold.

Three kernels keep scratch per (device, stream) -- the attention kernels'
split partials and arrival counters (``decode_attend``), the split-K
partials of ``decompress_matmul`` and the histogram's row partials
(``exp_histogram``) -- grown on demand.  A captured graph bakes in the
address of every buffer its kernels used, so a workspace that grows is
never freed: the old buffer is retired, kept alive for the life of the
process, and a graph that holds it replays as before.  A workspace grows
at least twofold, so a run whose shapes keep growing retires a number of
buffers logarithmic in the largest size, and their bytes sum to less than
the live buffer's.  Growing while the
stream is being captured raises: the buffer would come from the graph's
private pool, sized to that one capture.  A capture warms up on its
stream first, which sizes every workspace it will bake in
(``ops.CapturedStep``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

_retired: List[torch.Tensor] = []


def sized(old: Optional[torch.Tensor], numel: int, dtype: torch.dtype,
          device, zeroed: bool = False) -> torch.Tensor:
    """``old`` if it holds ``numel`` elements, else a new buffer of at
    least ``numel``, 1 and twice ``old``'s elements (zero-filled when
    ``zeroed``), ``old`` retired."""
    if old is not None and old.numel() >= numel:
        return old
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a kernel workspace would grow inside a CUDA graph capture: "
            "run the captured step once on the capture stream first")
    size = max(numel, 1)
    if old is not None:
        _retired.append(old)
        size = max(size, 2 * old.numel())
    make = torch.zeros if zeroed else torch.empty
    return make(size, dtype=dtype, device=dev)
