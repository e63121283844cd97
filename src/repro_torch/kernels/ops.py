"""Public wrappers around the port's CUDA kernels, the decode and weight
backend resolution, and the kernels' build and loader (ports
``repro/kernels/ops.py``).

Every wrapper takes the kernel's plain PyTorch version for a CPU tensor
and launches the kernel for a CUDA tensor; it never falls back from one to
the other.  Each kernel module keeps a plain ``launches`` count that its
launcher bumps after a successful launch.

Build: the ``csrc/*.cu`` sources have a plain C interface; ``build()``
compiles each in its own ``nvcc`` process for ``sm_90a`` (all started
together) and links them into ONE shared library under
``<repo>/build/repro_torch/`` (git-ignored).  It happens at first use,
and again only when a source is newer than the library, which is then
loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import entropy as E
from repro_torch.core import fixed
from . import decode_attend as _attend
from . import decompress_matmul as _dm
from . import exp_histogram as _hist
from . import lexi_pack as _pack
from . import lexi_unpack as _unpack
from . import ref

# ---------------------------------------------------------------------------
# decode-attention backend
#
#   auto  -- the CUDA kernel for CUDA tensors, the plain version for CPU ones
#   cuda  -- the CUDA kernel; CPU tensors raise
#   torch -- the plain version; CUDA tensors raise (chip_smoke.py compares
#            kernel and plain version by calling both directly)
# ---------------------------------------------------------------------------

DECODE_BACKENDS = ("auto", "cuda", "torch")


def resolve_decode_backend(codec, device: torch.device) -> str:
    """Check ``codec.decode_backend`` against ``device`` and return what
    runs there: ``"cuda"`` (the kernel) or ``"torch"`` (the plain
    version).  The wrappers pick the same by the tensors' device."""
    be = getattr(codec, "decode_backend", "auto") if codec is not None \
        else "auto"
    if be not in DECODE_BACKENDS:
        raise ValueError(f"decode_backend must be one of {DECODE_BACKENDS}, "
                         f"got {be!r}")
    on_cuda = torch.device(device).type == "cuda"
    if be == "cuda" and not on_cuda:
        raise ValueError("decode_backend='cuda' needs CUDA tensors")
    if be == "torch" and on_cuda:
        raise ValueError("decode_backend='torch' is for CPU tensors: on "
                         "CUDA tensors attention runs the kernel")
    return "cuda" if on_cuda else "torch"


# ---------------------------------------------------------------------------
# serving weight-matmul backend (matmuls against core.weights.PackedWeight)
#
#   auto   -- cuda for CUDA tensors, torch for CPU ones
#   cuda   -- the fused decompress_matmul kernel; CPU tensors raise
#   unpack -- the lexi_unpack kernel, then the product on the exact bf16
#             weight (the same torch.mm as raw weights, so the streams equal
#             the raw weights' streams); CPU tensors raise
#   torch  -- the plain version (exact unpack, f32 product); CUDA tensors
#             raise
# ---------------------------------------------------------------------------

WEIGHT_BACKENDS = ("auto", "cuda", "unpack", "torch")


def check_weight_backend(be: str, device) -> None:
    """Raise unless the concrete backend ``be`` runs on ``device``."""
    if be not in WEIGHT_BACKENDS[1:]:
        raise ValueError(f"not a concrete weight backend: {be!r}")
    on_cuda = torch.device(device).type == "cuda"
    if be in ("cuda", "unpack") and not on_cuda:
        raise ValueError(f"weight_backend={be!r} needs CUDA tensors")
    if be == "torch" and on_cuda:
        raise ValueError("weight_backend='torch' is for CPU tensors: on "
                         "CUDA tensors packed weights run a kernel")


def resolve_weight_backend(codec, device: torch.device) -> str:
    """Check ``codec.weight_backend`` against ``device`` and return what
    runs there: ``"cuda"``, ``"unpack"`` or ``"torch"``."""
    be = getattr(codec, "weight_backend", "auto") if codec is not None \
        else "auto"
    if be not in WEIGHT_BACKENDS:
        raise ValueError(f"weight_backend must be one of {WEIGHT_BACKENDS}, "
                         f"got {be!r}")
    if be == "auto":
        be = "cuda" if torch.device(device).type == "cuda" else "torch"
    check_weight_backend(be, device)
    return be


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def histogram(x: torch.Tensor) -> torch.Tensor:
    """(G, n) bf16 -> (G, 256) int32 exponent histogram per row."""
    if x.device.type == "cpu":
        return _hist.plain(x)
    return _hist.exp_histogram(x)


def pack(x: torch.Tensor, enc_lut: torch.Tensor, k: int):
    """(G, n) bf16, (G, 256) int32 LUTs -> (signman, planes) per row."""
    if x.device.type == "cpu":
        return _pack.plain(x, enc_lut, k)
    return _pack.lexi_pack(x, enc_lut, k)


def unpack_rows(signman: torch.Tensor, planes: torch.Tensor,
                dicts: torch.Tensor, k: int) -> torch.Tensor:
    """(G, n) uint8, (G, k, pad32(n)/32) int32, (G, 2^k) uint8 per-row
    dictionaries -> (G, n) bf16, escape-free."""
    if signman.device.type == "cpu":
        return _unpack.plain(signman, planes, dicts, k)
    return _unpack.lexi_unpack(signman, planes, dicts, k)


def unpack(ct: fixed.Compressed) -> torch.Tensor:
    """Kernel-backed ``fixed.decompress`` (any leading batch axes): the
    escape-free unpack, then the escape side channel patched by position
    (the r-th escape takes ``esc_raw[r]``; escapes past the capacity keep
    the dictionary's ESCAPE slot, exponent 0, as ``fixed.decompress``)."""
    n, k = ct.n, ct.k
    lead = tuple(ct.signman.shape[:-1])
    g = math.prod(lead)
    sm = ct.signman.reshape(g, n)
    out = unpack_rows(sm, ct.planes.reshape(g, k, -1),
                      ct.dict_syms.reshape(g, -1), k)
    pos = ct.esc_pos.reshape(g, -1).to(torch.int64)
    fix = E.from_u16(E.combine(sm.gather(1, pos.clamp(max=n - 1)),
                               ct.esc_raw.reshape(g, -1)))
    # unused slots hold a position >= n: they land in a scratch column
    out = torch.cat([out, out.new_zeros((g, 1))], 1) \
        .scatter_(1, pos.clamp(max=n), fix)[:, :n]
    return out.reshape(lead + tuple(ct.shape))


def matmul_compressed(x: torch.Tensor, signman: torch.Tensor,
                      planes: torch.Tensor, dict_syms: torch.Tensor, *,
                      k: int = 6) -> torch.Tensor:
    """Fused just-in-time decompress + matmul: x (M, K) bf16 @ packed W
    (K, N) -> (M, N) f32."""
    if x.device.type == "cpu":
        return _dm.plain(x, signman, planes, dict_syms, k)
    return _dm.decompress_matmul(x, signman, planes, dict_syms, k)


def compress_weight(w: torch.Tensor, *, k: int = 6):
    """(K, N) bf16 -> (signman, planes, dict, n_escapes) for
    ``matmul_compressed``, on the tensor's device (the kernel-backed
    ``ref.compress_weight_2d``)."""
    kk, n = w.shape
    if n % 32:
        raise ValueError(f"N must be a multiple of 32, got {n}")
    row = w.to(torch.bfloat16).reshape(1, kk * n).contiguous()
    hist = histogram(row)
    dict_syms, enc_lut = fixed.build_dictionary(hist, k)
    n_escapes = (hist * (enc_lut == fixed.esc_index(k))).sum()
    signman, planes = pack(row, enc_lut, k)
    return (signman.reshape(kk, n), planes.reshape(k, kk, n // 32),
            dict_syms[0], n_escapes.to(torch.int32))


def matmul_packed(x: torch.Tensor, pw) -> torch.Tensor:
    """``x (..., K) @ W`` in f32 for a 2-D ``core.weights.PackedWeight``,
    on the backend baked into the leaf at pack time; a backend that does
    not run on x's device raises."""
    if pw.ndim != 2:
        raise ValueError(f"matmul needs a 2-D packed weight, got shape "
                         f"{tuple(pw.shape)}: slice stacked leaves first")
    check_weight_backend(pw.backend, x.device)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous()
    if pw.backend == "unpack":
        kk, n = pw.shape
        w = unpack_rows(pw.signman.reshape(1, kk * n),
                        pw.planes.reshape(1, pw.k, -1),
                        pw.dict_syms.reshape(1, -1), pw.k).reshape(kk, n)
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = matmul_compressed(x2, pw.signman, pw.planes, pw.dict_syms,
                                k=pw.k)
    return out.reshape(lead + (out.shape[-1],))


def decode_attend_paged(q, signman, planes, dicts, esc_pos, esc_raw,
                        raw_pages, ring, page_ids, lengths, window: int, *,
                        k: int, kv_idx: Sequence[int], scale: float,
                        softcap: Optional[float] = None):
    """Paged decompress + attend -> unnormalised (out, m, l); see
    ``kernels.decode_attend`` for the calling convention."""
    fn = _attend.plain if q.device.type == "cpu" \
        else _attend.decode_attend_paged
    return fn(q, signman, planes, dicts, esc_pos, esc_raw, raw_pages, ring,
              page_ids, lengths, window, k=k, kv_idx=kv_idx, scale=scale,
              softcap=softcap)


def launch_counts() -> Dict[str, int]:
    return {"decode_attend_paged": _attend.launches,
            "exp_histogram": _hist.launches,
            "lexi_pack": _pack.launches,
            "decompress_matmul": _dm.launches,
            "lexi_unpack": _unpack.launches}


def reset_launch_counts() -> None:
    _attend.launches = _hist.launches = _pack.launches = 0
    _dm.launches = _unpack.launches = 0


def check_cuda(t: torch.Tensor, dtype: torch.dtype, ndim: int,
               name: str) -> None:
    """Validate a kernel operand before its pointer is passed on."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.ndim}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raise_on_error(rc: int, what: str) -> None:
    if rc:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------------------
# build + loader
# ---------------------------------------------------------------------------

KERNELS = ("exp_histogram", "lexi_pack", "decode_attend_paged",
           "lexi_unpack", "decompress_matmul")
SOURCES = KERNELS + ("cuda_error",)
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIBRARY = BUILD_DIR / "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_SIGNATURES = {
    "exp_histogram_launch": [_P, _P, _I, _LL, _P],
    "lexi_pack_launch": [_P, _P, _P, _P, _I, _LL, _I, _P],
    "decode_attend_paged_launch": [_P] * 13 + [_I] * 10 + [_F, _F, _I, _P],
    "lexi_unpack_launch": [_P, _P, _P, _P, _I, _LL, _I, _P],
    "decompress_matmul_launch": [_P] * 5 + [_I] * 5 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, "
                           "/usr/local/cuda/bin)")
    return str(path)


def build() -> Dict[str, float]:
    """Rebuild the kernel library if any source is newer than it.

    Returns {source: seconds, "link": seconds} for a rebuild, {} when the
    library is current.  The compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills) of each source is kept in
    ``BUILD_DIR/<source>.log``.  Raises with the compiler output on
    failure."""
    srcs = [CSRC / f"{name}.cu" for name in SOURCES]
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= max(
            src.stat().st_mtime for src in srcs):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = nvcc_path(), os.getpid()
    procs = {}
    for name, src in zip(SOURCES, srcs):
        obj = BUILD_DIR / f"{name}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       obj, time.perf_counter())
    times, failed = {}, []
    for name, (proc, obj, t0) in procs.items():
        log = proc.communicate()[0]
        times[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
    objs = [str(obj) for _, obj, _ in procs.values()]
    try:
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp = LIBRARY.with_name(f"{LIBRARY.name}.{tag}.tmp")
        t0 = time.perf_counter()
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        times["link"] = time.perf_counter() - t0
        os.replace(tmp, LIBRARY)
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    return times


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if stale."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        for fn_name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_log(name: str) -> Optional[str]:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else None
