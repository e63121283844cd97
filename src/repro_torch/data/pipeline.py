"""Deterministic synthetic token pipeline (ports ``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step): the same numpy
``SeedSequence([seed, step])`` stream as the reference's, so a batch is
the reference's bit for bit and training resumes exactly after a restart.
Tokens and labels come out as int32 tensors of the global batch; a data
rank takes its contiguous slice of the batch dim (``shard_batch``), as the
reference's ``P("data")`` batch spec hands it out; every model rank of a
data index takes the same slice, the whole sequence (the vocab-sharded
embedding sums the ranks' partials of the same tokens).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    """Zipf-distributed LM batches with next-token labels."""

    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # Zipf via inverse-CDF on a truncated power law (fast, vectorized)
        u = rng.random((self.global_batch, self.seq_len + 1))
        ranks = np.floor(
            (u * (self.vocab_size ** (1 - self.zipf_a) - 1) + 1)
            ** (1 / (1 - self.zipf_a))).astype(np.int64)
        toks = np.clip(ranks - 1, 0, self.vocab_size - 1).astype(np.int32)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy())}


def shard_batch(batch: Dict[str, torch.Tensor], rank: int,
                world: int) -> Dict[str, torch.Tensor]:
    """Data rank ``rank``'s contiguous slice of the batch dim, of
    ``world`` data ranks (the same for every model rank)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"global batch {v.shape[0]} does not split over "
                             f"{world} data ranks")
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def for_config(cfg, shape, seed: int = 0) -> SyntheticLM:
    """The pipeline of ``cfg``'s vocabulary at ``shape`` (a ``ShapeConfig``);
    the multimodal stubs' extra inputs wait for their training slice."""
    if cfg.frontend == "vision_stub" or cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: VLM and enc-dec training inputs wait for their "
            "slice (ROADMAP.md, queue 1, item 4.2)")
    return SyntheticLM(vocab_size=cfg.vocab_size,
                       global_batch=shape.global_batch,
                       seq_len=shape.seq_len, seed=seed)
