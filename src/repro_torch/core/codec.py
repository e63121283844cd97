"""High-level LEXI codec API (a copy of ``repro/core/codec.py``, numpy
and the port's own LEXI-H modules).

``LexiCodec`` is the paper's LEXI-H (per-layer canonical Huffman,
variable-length, bit-exact, on the host: checkpoints, benchmarks and the
oracle).  The in-graph deployment codec is ``repro_torch.core.fixed``
(LEXI-FW); this module also has the compression-ratio helpers of paper
Table 2.  ``decompress_tensor`` returns a torch bf16 tensor where the
reference returns a numpy array of ``dtype`` (the same bits).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from . import baselines, bitstream, entropy, huffman


@dataclasses.dataclass
class LexiCodec:
    """Per-layer LEXI-H codec: fit on a stream, then encode / decode
    exactly."""

    main_alphabet: int = huffman.MAIN_ALPHABET
    max_len: int = huffman.MAX_CODE_LEN
    book: huffman.Codebook | None = None

    def fit(self, exp_stream: np.ndarray,
            n_train: int | None = 512) -> "LexiCodec":
        """Build the codebook from the first ``n_train`` symbols (paper
        section 4.1: the tree is trained on a layer's first 512
        activations)."""
        x = np.asarray(exp_stream, dtype=np.uint8).reshape(-1)
        if n_train is not None:
            x = x[:n_train]
        hist = np.bincount(x, minlength=256).astype(np.float64)
        self.book = huffman.build_codebook(hist,
                                           main_alphabet=self.main_alphabet,
                                           max_len=self.max_len)
        return self

    def encode(self, exp_stream: np.ndarray) -> bitstream.EncodedStream:
        assert self.book is not None, "call fit() first"
        return bitstream.encode(np.asarray(exp_stream, dtype=np.uint8),
                                self.book)

    def decode(self, stream: bitstream.EncodedStream) -> np.ndarray:
        return bitstream.decode(stream)

    # -- whole-tensor helpers ---------------------------------------------
    @staticmethod
    def compress_tensor(x) -> bytes:
        return bitstream.compress_bf16(entropy.to_bf16_u16(x))

    @staticmethod
    def decompress_tensor(blob: bytes, shape) -> torch.Tensor:
        u16 = bitstream.decompress_bf16(blob)
        return torch.from_numpy(u16.view(np.int16).copy()) \
            .view(torch.bfloat16).reshape(shape)


def measure_crs(x) -> Dict[str, float]:
    """Exponent-stream CRs of every method in paper Table 2 on one
    tensor."""
    _, exp, _ = entropy.split_fields(entropy.to_bf16_u16(x))
    exp = exp.reshape(-1)
    return {
        "base": 1.0,
        "rle": baselines.rle_cr(exp),
        "bdi": baselines.bdi_cr(exp),
        "lexi": huffman.compression_ratio(exp),
    }


def overall_bf16_ratio(exp_cr: float) -> float:
    """Whole-value CR given an exponent CR (sign + mantissa = 8 bits
    verbatim)."""
    return 16.0 / (8.0 + 8.0 / exp_cr)
