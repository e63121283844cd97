"""Fused just-in-time weight decompression + matmul: the CUDA kernel
``csrc/decompress_matmul.cu`` (replaces the Pallas kernel
``repro/kernels/decompress_matmul.py:decompress_matmul``) and its plain
PyTorch twin.

``decompress_matmul`` launches the kernel on CUDA tensors only; ``plain``
is the same function in torch ops (``ref.decompress_matmul_ref``: exact
unpack, then an f32 product).  Callers go through
``kernels.ops.matmul_compressed`` / ``kernels.ops.matmul_packed``.

The kernel has two routes, and ``plan`` picks one from (M, K, N, k) on
the host:

* ``decode`` (M <= ``DECODE_MAX_M``, the engine's slot counts): split-K.
  The grid is (N / bn, splits, M-groups): each CTA reads one bn-column
  tile of ``depth`` rows of the packed W and up to 32 rows of x, and the
  last CTA of each column tile to arrive sums the splits' partials in
  split order, in the same launch.  ``plan`` sizes the grid so that it
  reaches ``TARGET_CTAS`` (two CTAs per SM) where it can, keeping each
  split at least ``MIN_SPLIT_ROWS`` deep and the f32 partials at most
  1/``WS_SHARE`` of the packed W bytes.  The partials and the arrival
  counters live in a workspace kept per (device, stream) (``_workspace``),
  which the kernel leaves zeroed.
* ``prefill`` (larger M; ``csrc/decompress_matmul_prefill.cu``): wgmma on
  BM x 128 output tiles (BM 128 or 256, ``PREFILL_TILES``), the K loop in
  the CTA; a producer warpgroup decodes each 64-row tile of W into shared
  memory while the consumer warpgroups' products of earlier tiles run.
  The grid is (M tiles, N tiles), one CTA per SM; ``plan`` picks the tile
  per shape by ``prefill_cost`` (whole waves times a K step's measured
  cost).  One CTA owns each output: no workspace.

Unlike the reference's wrapper, nothing is padded on the host: the kernel
masks the ragged M, K and N edges itself.  N must be a multiple of 32
(the packed format's word).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core import packing
from . import ref, workspace

plain = ref.decompress_matmul_ref

launches = 0          # kernel launches since the last reset
launches_by_route = {"decode": 0, "prefill": 0}

DECODE_MAX_M = 96     # the decode route's largest M (chip_smoke.py's M sweep)
TARGET_CTAS = 264     # two CTAs on each of an H100's 132 SMs
MIN_SPLIT_ROWS = 256  # the shallowest split worth its partial
WS_SHARE = 8          # partials at most 1/8 of the packed W bytes
CHUNK_BYTES = 8192    # signman bytes of one decode-route ring stage
MAX_CTA_ROWS = 32     # rows of x one decode-route CTA holds (4 m8 tiles)
PREFILL_BK = 64       # K rows per prefill step (128 bytes of x)
PREFILL_RINGS = (4, 3, 3)   # prefill slots: decoded W, x, packed W
SMS = 132             # an H100's SMs; the prefill route runs one CTA each
# the prefill route's (BM, BN) tiles and the relative cost of one K step
# of each, one CTA per SM: on the H100 a 256-row step took 1.25-1.37x a
# 128-row one at qwen3-4b's five block shapes (scripts/prefill_probe.py)
PREFILL_STEP_COST = {(128, 128): 1.0, (256, 128): 1.3}
PREFILL_TILES = tuple(PREFILL_STEP_COST)
MAX_SMEM = 232448     # an H100 CTA's shared memory
MAX_GRID_YZ = 65535


class Plan(NamedTuple):
    """One launch's route and shape.  ``decode``: column tile ``bn``,
    ``splits`` splits of ``depth`` rows (a multiple of the ring's
    ``rows``-row chunk), ``mrows`` rows of x per CTA.  ``prefill``: tiles
    of ``mrows`` x ``bn`` (one of ``PREFILL_TILES``), ``rows`` =
    ``PREFILL_BK``, one split of all K."""
    route: str
    bn: int
    splits: int
    depth: int
    rows: int
    mrows: int

    def grid(self, m: int, n: int) -> Tuple[int, int, int]:
        """The launch grid: decode (N / bn, splits, M-groups); prefill
        (M tiles, N tiles, 1), M fastest."""
        if self.route == "prefill":
            return (-(-m // self.mrows), -(-n // self.bn), 1)
        return (-(-n // self.bn), self.splits, -(-m // self.mrows))

    def ctas(self, m: int, n: int) -> int:
        x, y, z = self.grid(m, n)
        return x * y * z

    def workspace_floats(self, m: int, n: int) -> int:
        """f32 partials of splits 1.. (split 0 writes ``out`` itself)."""
        return (self.splits - 1) * m * n if self.route == "decode" else 0

    def counters(self, m: int, n: int) -> int:
        x, _, z = self.grid(m, n)
        return x * z if self.route == "decode" and self.splits > 1 else 0


def chunk_rows(bn: int) -> int:
    """Rows of W in one decode-route ring stage: CHUNK_BYTES of signman,
    at most 128 rows (finer split depths for narrow tiles)."""
    return min(CHUNK_BYTES // bn, 128)


def packed_bytes(kk: int, n: int, k: int) -> int:
    """Bytes of a packed (K, N) weight at code width k: signman and
    planes (the dictionary aside)."""
    return kk * n + k * kk * n // 8


def prefill_smem_bytes(bm: int, bn: int, k: int) -> int:
    """Dynamic shared memory per CTA of a prefill launch (as
    ``csrc/decompress_matmul_prefill.cu:smem_bytes``): the rings of
    decoded bf16 W tiles, x tiles and packed W tiles (the signman and k
    plane tiles, rounded up to 1 KB; ``PREFILL_RINGS`` slots each), and
    1 KB to align the swizzled tiles."""
    bk = PREFILL_BK
    packed = -(-(bk * bn + k * bk * bn // 8) // 1024) * 1024
    nw, nx, npk = PREFILL_RINGS
    return nw * bk * bn * 2 + nx * bm * bk * 2 + npk * packed + 1024


def prefill_cost(m: int, n: int, bm: int, bn: int) -> float:
    """Relative time of a prefill launch on tiles of bm x bn: whole waves
    of one CTA per SM, times a K step's cost (``PREFILL_STEP_COST``)."""
    ctas = -(-m // bm) * -(-n // bn)
    return -(-ctas // SMS) * PREFILL_STEP_COST[(bm, bn)]


@functools.lru_cache(maxsize=None)
def plan(m: int, kk: int, n: int, k: int, route: str = "auto") -> Plan:
    """The launch for x (m, kk) @ packed W (kk, n) at code width k.
    ``route`` forces ``"decode"`` or ``"prefill"`` (chip_smoke.py's M
    sweep, which checks ``DECODE_MAX_M``, times both); ``"auto"`` takes
    decode up to ``DECODE_MAX_M``.

    Decode: in order of preference, the fewest M-groups (each decodes
    the whole W again) and then the widest column tile; for each, the
    fewest splits that reach ``TARGET_CTAS``, each split a whole number
    of chunks, at least ``MIN_SPLIT_ROWS`` deep (or all of K) and the
    partials within 1/``WS_SHARE`` of the packed W.  When no choice
    reaches the target (a small W), the one with the most CTAs.

    Prefill: the tile of least ``prefill_cost``, the first of
    ``PREFILL_TILES`` on a tie."""
    if route not in ("auto", "decode", "prefill"):
        raise ValueError(f"route must be auto, decode or prefill: {route!r}")
    if route == "prefill" or (route == "auto" and m > DECODE_MAX_M):
        bm, bn = min(PREFILL_TILES,
                     key=lambda t: prefill_cost(max(m, 1), n, *t))
        return Plan("prefill", bn, 1, kk, PREFILL_BK, bm)
    cap_splits = 1 + packed_bytes(kk, n, k) // WS_SHARE // (4 * max(m, 1) * n)
    best = None
    for mrows in (32, 16, 8):
        if mrows < MAX_CTA_ROWS and m <= mrows:
            continue                    # no more M-groups than 32 rows give
        groups = max(1, -(-m // mrows))
        for bn in (128, 64, 32):
            rows = chunk_rows(bn)
            tiles = max(1, -(-n // bn) * groups)
            most = max(1, min(kk // max(MIN_SPLIT_ROWS, rows), cap_splits))
            s = min(-(-TARGET_CTAS // tiles), most)
            while True:
                depth = -(-max(1, -(-kk // s)) // rows) * rows
                splits = max(1, -(-kk // depth))
                p = Plan("decode", bn, splits, depth, rows,
                         min(mrows, max(8, -(-m // 8) * 8)))
                if tiles * splits >= TARGET_CTAS or s >= most:
                    break
                s += 1
            if tiles * splits >= TARGET_CTAS:
                return p
            if best is None or tiles * splits > best[0]:
                best = (tiles * splits, p)
    return best[1]


@functools.lru_cache(maxsize=None)
def _launch(m: int, kk: int, n: int, k: int, route: str, vec_x: bool,
            planes16: bool, planes8: bool):
    """Everything a launch needs from its shape, computed once per shape:
    (plan, workspace floats, counters, the kernel's 12 shape ints as one C
    array).  ``planes16``/``planes8``: the plane words' alignment, which
    picks the widest plane copy the column tile allows."""
    p = plan(m, kk, n, k, route)
    _, gy, gz = p.grid(m, n)
    if max(gy, gz) > MAX_GRID_YZ or max(m, kk, n) >= 1 << 31:
        raise ValueError(f"shape {(m, kk, n)} is too large for one launch")
    nw = n // packing.LANES
    if p.bn >= 128 and nw % 4 == 0 and planes16:
        pl_copy = 16
    elif p.bn >= 64 and nw % 2 == 0 and planes8:
        pl_copy = 8
    else:
        pl_copy = 4
    shape = (ctypes.c_int * 12)(
        m, kk, n, k, int(vec_x), int(p.route == "decode"), p.bn, p.rows,
        p.depth, p.splits, p.mrows, pl_copy)
    return p, p.workspace_floats(m, n), p.counters(m, n), shape


# (device, stream handle) -> (partials, arrival counters, their sizes and
# data pointers), grown on demand as ``kernels.workspace`` says
_workspaces: Dict[Tuple[torch.device, int], tuple] = {}


def _workspace(device, stream: int, floats: int, counters: int
               ) -> Tuple[int, int]:
    """Data pointers of the split workspace for one launch on ``stream``:
    ``floats`` f32 partials and ``counters`` int32 arrival counters
    (allocated zeroed; every launch leaves them zero).  Launches on one
    stream run one after another and share it; two streams could overlap,
    so each has its own."""
    entry = _workspaces.get((device, stream))
    if entry is None or entry[2] < floats or entry[3] < counters:
        ws, cnt = entry[:2] if entry is not None else (None, None)
        ws = workspace.sized(ws, floats, torch.float32, device)
        cnt = workspace.sized(cnt, counters, torch.int32, device,
                              zeroed=True)
        entry = _workspaces[(device, stream)] = (
            ws, cnt, ws.numel(), cnt.numel(), ws.data_ptr(), cnt.data_ptr())
    return entry[4], entry[5]


def smem_bytes(p: Plan, k: int) -> int:
    """Dynamic shared memory per CTA of a launch, from the kernel
    library."""
    from .ops import library
    if p.route == "prefill":
        return library().decompress_matmul_prefill_smem(p.bn, p.mrows, k)
    return library().decompress_matmul_smem(p.bn, p.rows, k, p.mrows)


def decompress_matmul(x: torch.Tensor, signman: torch.Tensor,
                      planes: torch.Tensor, dict_syms: torch.Tensor,
                      k: int, *, route: str = "auto") -> torch.Tensor:
    """x (M, K) bf16 @ packed W (K, N) -> (M, N) f32.  W: signman (K, N)
    uint8, planes (k, K, N/32) int32-held words, dict_syms (2^k,) uint8.
    ``route`` as in :func:`plan`."""
    global launches
    from .ops import check_cuda, library, raise_on_error

    check_cuda(x, torch.bfloat16, 2, "x")
    check_cuda(signman, torch.uint8, 2, "signman")
    check_cuda(planes, torch.int32, 3, "planes")
    check_cuda(dict_syms, torch.uint8, 1, "dict_syms")
    m, kk = x.shape
    if not 1 <= k <= 8:
        raise ValueError(f"k must be in 1..8, got {k}")
    if signman.shape[0] != kk:
        raise ValueError(f"x has K={kk}, W has K={signman.shape[0]}")
    n = signman.shape[1]
    if n % packing.LANES:
        raise ValueError(f"N must be a multiple of 32, got {n}")
    if planes.shape != (k, kk, n // packing.LANES) \
            or dict_syms.shape != (1 << k,):
        raise ValueError(f"planes {tuple(planes.shape)} / dict "
                         f"{tuple(dict_syms.shape)} do not match W {(kk, n)} "
                         f"at k={k}")
    xp, sp, pp = x.data_ptr(), signman.data_ptr(), planes.data_ptr()
    if sp % 16:
        raise ValueError("signman must be 16-byte aligned")
    p, floats, counters, shape = _launch(
        m, kk, n, k, route, kk % 8 == 0 and xp % 16 == 0, pp % 16 == 0,
        pp % 8 == 0)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = cnt = None
    if p.splits > 1:
        ws, cnt = _workspace(x.device, stream, floats, counters)
    rc = library().decompress_matmul_launch(
        xp, sp, pp, dict_syms.data_ptr(), out.data_ptr(), ws, cnt, shape,
        stream)
    raise_on_error(rc, "decompress_matmul")
    launches += 1
    launches_by_route[p.route] += 1
    return out
