"""``CodecConfig``: where and how LEXI applies in a run.

Ports the config half of ``repro/core/collectives.py``.  The compressed
collectives themselves (``compressed_all_gather``, ``compressed_psum``,
``compressed_all_to_all``, ``compressed_ppermute`` and the ``lexi_*``
custom-VJP wrappers) wait for the multi-GPU slice: at one GPU every one of
them is the identity.

Class name, field order and defaults match the JAX package's, so
``repr(CodecConfig())`` is the same string in both packages.  Only the
backend vocabulary differs, as documented per field.
"""

from __future__ import annotations

import dataclasses

from .fixed import DEFAULT_ESC_FRAC, DEFAULT_K


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Where/how LEXI applies in a model run (first-class config knob)."""

    enabled: bool = True                # master switch (activations/ICI)
    weights: bool = True                # compressed-at-rest params (+FSDP AG)
    cache: bool = True                  # block-compressed hybrid caches
    grads: bool = True                  # compressed AG half of grad sync
    k: int = DEFAULT_K                  # dictionary index width (bits)
    esc_frac: int = DEFAULT_ESC_FRAC    # escape capacity = N // esc_frac
    cache_block: int = 256              # tokens per compressed KV block
    # decode-attention backend: auto | cuda | torch (see
    # repro_torch.kernels.ops.resolve_decode_backend).  auto = the CUDA
    # kernel for CUDA tensors, the plain PyTorch version for CPU tensors.
    decode_backend: str = "auto"
    # serving weight-matmul backend; only "auto" exists until the packed
    # weight plane is ported
    weight_backend: str = "auto"

    def esc_capacity(self, n: int) -> int:
        return max(n // self.esc_frac, 8)

    @classmethod
    def off(cls) -> "CodecConfig":
        return cls(enabled=False, weights=False, cache=False, grads=False)

    @classmethod
    def weights_only(cls) -> "CodecConfig":
        """Paper Table 3 middle row: offline-compressed weights only."""
        return cls(enabled=False, weights=True, cache=False, grads=False)


DEFAULT_CODEC = CodecConfig()
