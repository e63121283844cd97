"""Shared SHA-256 content addressing for pages and prefixes (a copy of
``repro/serve/digest.py``; hashlib and numpy only).

One module owns both hash conventions the serving stack keys on, so the
transport's digest store, the scheduler's prefix index, and the tiered
``PageCache`` all speak the same keys:

* **Page digests** — ``sha256(payload)[:DIGEST_BYTES]`` of one immutable
  page payload (the LEXI-FW compressed bytes, or the raw bf16 page when
  the codec is off).  Pages are content-deterministic — the same prefix
  always compresses to the same bytes — so a truncated SHA-256 is a
  collision-safe identity for dedup, spill, and remote fetch.
* **Prefix keys** — chained full-width SHA-256 over the token prompt, one
  32-byte key per FULL page column (``blk_tokens = cache_block * tp``
  tokens).  Chaining makes key ``c`` a digest of the whole prefix
  ``prompt[: (c+1) * blk_tokens]`` at O(len) total cost, and two prompts
  share key ``c`` iff they share that prefix exactly.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np

DIGEST_BYTES = 12


def page_digest(payload: bytes) -> bytes:
    """Truncated content digest of one immutable page payload."""
    return hashlib.sha256(payload).digest()[:DIGEST_BYTES]


def chain_keys(prompt: np.ndarray, n_cols: int,
               blk_tokens: int) -> List[bytes]:
    """Chained prefix keys for the first ``n_cols`` full page columns of
    ``prompt``; ``keys[c]`` identifies ``prompt[: (c+1) * blk_tokens]``."""
    keys: List[bytes] = []
    h = b""
    for c in range(n_cols):
        blk = np.ascontiguousarray(
            prompt[c * blk_tokens:(c + 1) * blk_tokens],
            dtype=np.int32).tobytes()
        h = hashlib.sha256(h + blk).digest()
        keys.append(h)
    return keys
