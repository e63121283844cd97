#!/usr/bin/env python3
"""Probe the codec kernels (``exp_histogram``, ``lexi_pack``) on one NVIDIA
GPU: how their time moves with the grid's fill, and what bounds them.

    python3 scripts/codec_probe.py [--fill 264,396,528] [--variants all]

Times both kernels at chip_smoke.py's four codec shapes with its
``cuda_ms`` (L2 flushed, spin):

  fill      for each value of ``--fill``, ``exp_histogram.FILL_CTAS`` and
            ``lexi_pack.FILL_CTAS`` (the CTAs a launch aims at, in all) set
            to it, each result checked bit for bit against the shipped
            fill's.  The histogram's CTAs hold 64 KB of shared memory
            each, so at most three are resident on an SM: a fill above 396
            runs in more than one wave;
  variants  the sources built again under ``build/codec_probe/``
            (git-ignored) with the text edits in EDITS, each into a
            library of its own that the wrappers are pointed at:
              hist_atomic    a count is a shared-memory atomicAdd, not a
                             load, an add and a store;
              hist_no_count  loads only, no counting (results wrong);
              hist_no_merge  every CTA writes its count as the row's, no
                             partials or arrival (results wrong);
              hist_depth3    three batches of loads in flight, not two;
              hist_ldg, hist_ldcg
                             the vectors loaded through the read-only
                             cache, or cached in the L2 only, instead of
                             as streaming loads (evict first);
              pack_no_encode loads and stores only: the loaded words
                             stored as they are (results wrong).

Prints the ptxas report of each variant, one JSON line, and appends it to
chiprun_out/codec_probe.jsonl.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT_DIR = ROOT / "build" / "codec_probe"
SOURCES = ("exp_histogram", "lexi_pack", "cuda_error")

# variant -> [(source, text, replacement)]
EDITS = {
    "hist_atomic": [("exp_histogram", "  *c += 1u << ((w >> 4) & 24u);",
                     "  atomicAdd(c, 1u << ((w >> 4) & 24u));")],
    "hist_no_count": [("exp_histogram",
                       "count_item<Vec>(col, cur[u]);",
                       "mine ^= cur[u].x ^ cur[u].y ^ cur[u].z ^ cur[u].w;")],
    "hist_no_merge": [("exp_histogram", "  if (gridDim.x == 1) {",
                       "  if (true) {")],
    "hist_depth3": [("exp_histogram", "constexpr int kDepth = 2;",
                     "constexpr int kDepth = 3;")],
    "hist_ldg": [("exp_histogram", "return __ldcs(", "return __ldg(")],
    "hist_ldcg": [("exp_histogram", "return __ldcs(", "return __ldcg(")],
    "pack_no_encode": [("lexi_pack",
                        "    lexi::encode32<KB>(cur, code_of, smv, bits);",
                        "    smv[0] = make_uint4(cur[0], cur[1], cur[2], cur[3]);\n"
                        "    smv[1] = make_uint4(cur[4], cur[5], cur[6], cur[7]);\n"
                        "#pragma unroll\n"
                        "    for (int b = 0; b < KB; ++b) bits[b] = cur[8 + b];")],
}


def build_variants(names):
    """{variant: loaded library}; each source edited, compiled and linked
    on its own (the three compiles of a variant run in parallel)."""
    from repro_torch.kernels import ops
    nvcc = ops.nvcc_path()
    libs = {}
    for name in names:
        vdir = OUT_DIR / name
        vdir.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in SOURCES:
            text = (CSRC / f"{src}.cu").read_text()
            for where, old, new in EDITS[name]:
                if where == src:
                    assert old in text, (name, old)
                    text = text.replace(old, new)
            path = vdir / f"{src}.cu"
            path.write_text(text)
            procs.append(subprocess.Popen(
                [nvcc, *ops.NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                 str(vdir / f"{src}.o"), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, proc in zip(SOURCES, procs):
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}/{src}:\n{log}")
            if src != "cuda_error":
                print(f"[{name}] {src}: " + " | ".join(
                    line.split("info    : ")[-1] for line in log.splitlines()
                    if "registers" in line or "spill" in line))
        so = vdir / "lib.so"
        subprocess.run([nvcc, "-shared", "-o", str(so),
                        *(str(vdir / f"{s}.o") for s in SOURCES)], check=True)
        lib = ctypes.CDLL(str(so))
        for fn in ("exp_histogram_launch", "lexi_pack_launch"):
            getattr(lib, fn).argtypes = ops._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fill", default="264,396,528")
    ap.add_argument("--variants", default="all",
                    help="comma-separated names from EDITS, all, or none")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("codec_probe.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import fixed
    from repro_torch.kernels import exp_histogram, lexi_pack, ops

    ops.build()
    base = ops.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    names = (list(EDITS) if opts.variants == "all" else [] if
             opts.variants == "none" else opts.variants.split(","))
    libs = build_variants(names)
    k = 5
    gen = torch.Generator(device="cuda").manual_seed(0)
    pages = cs._pages(gen, 16, 256, 2048).reshape(16, -1)
    shipped = (exp_histogram.FILL_CTAS, lexi_pack.FILL_CTAS)
    rec = dict(card=card, shipped=shipped, shapes={})

    def times(x, lut):
        return dict(exp_histogram=cs.cuda_ms(lambda: ops.histogram(x)),
                    lexi_pack=cs.cuda_ms(lambda: ops.pack(x, lut, k)))

    for name, x in cs.codec_inputs(gen, pages):
        hist = ops.histogram(x)
        lut = fixed.build_dictionary(hist, k)[1]
        sm, pl = ops.pack(x, lut, k)
        by_fill = {}
        for fill in map(int, opts.fill.split(",")):
            exp_histogram.FILL_CTAS = lexi_pack.FILL_CTAS = fill
            assert torch.equal(ops.histogram(x), hist), (name, fill)
            sm2, pl2 = ops.pack(x, lut, k)
            assert torch.equal(sm2, sm) and torch.equal(pl2, pl), (name, fill)
            del sm2, pl2
            by_fill[fill] = times(x, lut)
        exp_histogram.FILL_CTAS, lexi_pack.FILL_CTAS = shipped
        by_variant = {"base": times(x, lut)}
        for vname, lib in libs.items():
            ops._lib = lib
            try:
                by_variant[vname] = times(x, lut)
            finally:
                ops._lib = base
        rec["shapes"][name] = dict(shape=list(x.shape),
                                   bound_ms=cs.codec_bounds(*x.shape, k),
                                   ms_by_fill=by_fill,
                                   ms_by_variant=by_variant)
        print(name, json.dumps(rec["shapes"][name]), flush=True)
        del x, sm, pl
        torch.cuda.empty_cache()
    line = json.dumps(rec)
    print(line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "codec_probe.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
