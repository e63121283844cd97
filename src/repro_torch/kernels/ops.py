"""Public wrappers around the port's CUDA kernels, the decode backend
resolution, and the kernels' build and loader (ports
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
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from . import decode_attend as _attend
from . import exp_histogram as _hist
from . import lexi_pack as _pack
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
            "lexi_pack": _pack.launches}


def reset_launch_counts() -> None:
    _attend.launches = _hist.launches = _pack.launches = 0


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

KERNELS = ("exp_histogram", "lexi_pack", "decode_attend_paged")
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
