#!/usr/bin/env python3
"""Probe decompress_matmul's prefill route on one NVIDIA GPU: what bounds
it, and which tile each of qwen3-4b's weight shapes wants.

    python3 scripts/prefill_probe.py [--m 1024,256] [--diagnose]

Builds variants of ``src/repro_torch/csrc/decompress_matmul_prefill.cu``
under ``build/prefill_probe/`` (git-ignored), each linked with the
decode route into a library of its own:

  base       the kernel as it is;
  no_decode  decode16 replaced by zeros: loads, stores of a zero W tile,
             and the wgmma products (zeros in W);
  no_mma     the wgmma products left out: loads and the decode only;
  mma_bare   nothing copied, decoded or stored: the products and the
             hand-over of the W ring;
  hint       the mbarrier waits with a suspend-time hint (1 ms), so a
             waiting warp need not spin (also without the products);
  sleep      the mbarrier waits backing off by __nanosleep(64).

For every prefill tile (``decompress_matmul.PREFILL_TILES``), each of
qwen3-4b's six (K, N) weight shapes (packed from N(0, 0.02) on the card)
and each M, it times the variants (chip_smoke.py's ``cuda_ms``:
CUDA events, L2 flushed, a spin before each launch) and checks ``base``
against the plain version within 1e-4 * (|x| @ |W|) + 1e-6.  Then the
1024-token pass (the 252 block matmuls of qwen3-4b's 36 layers) is summed
for each variant on the plan's tiles.  It prints the ptxas report and the
count of HGMMA instructions in each variant's prefill kernels, and
appends one JSON line to chiprun_out/prefill_probe.jsonl.

``--diagnose`` first runs the base kernel on one-hot rows of x (x[m, k]
= 1 for k = m mod K) at M = 128, K = 64, N = 256: each output row is
then one row of W, and where it is not, the (row, column) of W that each
wrong output equals is printed (a wrong swizzle or descriptor shows as a
permutation).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT_DIR = ROOT / "build" / "prefill_probe"

# edits of decompress_matmul_prefill.cu: name -> [(text, replacement)]
EDITS = {
    "no_decode": [
        ("      lexi::decode16<KB>(smv[u][i], bits[u][i], lut, h[u][2 * i],\n"
         "                         h[u][2 * i + 1]);\n",
         "      h[u][2 * i] = h[u][2 * i + 1] = make_uint4(0, 0, 0, 0);\n")],
    "hint": [('"mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"',
              '"mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, 1000000;\\n"')],
    "sleep": [("    if (++spins == (1u << 24)) __trap();",
               "    if (++spins == (1u << 24)) __trap(); else __nanosleep(64);")],
    "no_mma": [
        ("      Wgmma::mma(acc[mt], desc128(xs + mt * 64 * 128 + kk * 32, 16, 1024),\n",
         "      if (0) Wgmma::mma(acc[mt], desc128(xs + mt * 64 * 128 + kk * 32, 16, 1024),\n")],
    "no_x": [
        ("      cp_async16(xs + m * 128 + ((c ^ (m & 7)) << 4),\n"
         "                 ok ? a.x + (long long)gm * a.K + kc : a.x, ok ? 16 : 0);\n",
         "      (void)ok;\n")],
    "no_w": [
        ("      cp_async16(sm + r * kBN + (((2 * o.q + h) ^ o.sw) << 4), src + 16 * h,\n",
         "      if (0) cp_async16(sm + r * kBN + (((2 * o.q + h) ^ o.sw) << 4), src + 16 * h,\n"),
        ("      cp_async4(pl + b * kBK * kWPR,\n", "      if (0) cp_async4(pl + b * kBK * kWPR,\n")],
    "no_store": [("      *(uint4*)(row + (((4 * (o.q & 1) + i) ^ o.sw) << 4)) =\n"
                  "          r < valid ? h[u][i] : make_uint4(0, 0, 0, 0);\n",
                  "      (void)row;\n")],
}
# variant -> the edits it makes
VARIANTS = {
    "base": [],
    "no_decode": ["no_decode"],          # zeros in W
    "no_mma": ["no_mma"],                # loads and the decode only
    "mma_bare": ["no_x", "no_w", "no_decode", "no_store"],
    "hint": ["hint"],                    # waits with a suspend-time hint
    "hint_no_mma": ["hint", "no_mma"],
    "sleep": ["sleep"],                  # waits backing off by nanosleep
}


def build_variants():
    """{variant: ctypes library}; every source compiled in parallel."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = ops.nvcc_path()
    flags = [*ops.NVCC_FLAGS, f"-I{CSRC}"]
    text = (CSRC / "decompress_matmul_prefill.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in (sub for e in edits for sub in EDITS[e]):
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        path = OUT_DIR / f"prefill_{name}.cu"
        path.write_text(src)
        jobs[name] = path
    jobs["decode"] = CSRC / "decompress_matmul.cu"
    jobs["cuda_error"] = CSRC / "cuda_error.cu"
    procs = {name: subprocess.Popen(
        [nvcc, *flags, "-c", "-o", str(OUT_DIR / f"{name}.o"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in jobs.items()}
    t0 = time.perf_counter()
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
    print(f"[build] {len(procs)} sources in {time.perf_counter() - t0:.1f}s",
          flush=True)
    libs = {}
    for name in VARIANTS:
        so = OUT_DIR / f"lib_{name}.so"
        subprocess.run([nvcc, "-shared", "-o", str(so),
                        str(OUT_DIR / f"{name}.o"),
                        str(OUT_DIR / "decode.o"),
                        str(OUT_DIR / "cuda_error.o")], check=True)
        lib = ctypes.CDLL(str(so))
        lib.decompress_matmul_launch.argtypes = \
            ops._SIGNATURES["decompress_matmul_launch"]
        lib.decompress_matmul_launch.restype = ctypes.c_int
        libs[name] = lib
        report(name, logs[name], so)
    return libs


def report(name, log, so):
    """ptxas lines of the prefill kernels, warnings, and HGMMA counts."""
    lines = [ln for ln in log.splitlines() if "warning" in ln.lower()
             or "prefill_kernel" in ln or "registers" in ln
             or "stack" in ln or "(C7" in ln]
    keep, fn = [], None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
            continue
        if "warning" in ln.lower() or "(C7" in ln:
            keep.append(ln.strip()[:160])
        elif fn and "prefill_kernel" in fn and ("registers" in ln
                                                  or "stack" in ln):
            keep.append(f"{fn[-40:]}: {ln.strip()}")
    print(f"[ptxas] {name}: " + " | ".join(keep[:12]), flush=True)
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
        "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
        elif fn and "prefill_kernel" in fn and "HGMMA" in ln:
            counts[fn] = counts.get(fn, 0) + 1
    print(f"[sass] {name}: HGMMA per prefill kernel "
          f"{sorted(set(counts.values()))} in {len(counts)} kernels",
          flush=True)


def launch(lib, x, fields, k, out, bn, bm):
    from repro_torch.kernels import ops
    m, kk = x.shape
    n = fields[0].shape[1]
    vec_x = int(kk % 8 == 0 and x.data_ptr() % 16 == 0)
    shape = (ctypes.c_int * 12)(m, kk, n, k, vec_x, 0, bn, 64, kk, 1, bm, 4)
    import torch
    rc = lib.decompress_matmul_launch(
        x.data_ptr(), fields[0].data_ptr(), fields[1].data_ptr(),
        fields[2].data_ptr(), out.data_ptr(), None, None, shape,
        torch.cuda.current_stream().cuda_stream)
    ops.raise_on_error(rc, "probe")


def diagnose(lib):
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    m, kk, n = 128, 64, 256
    w = (torch.randn((kk, n), generator=gen, device="cuda") * 0.02
         ).to(torch.bfloat16)
    sm, pl, d, _ = ops.compress_weight(w, k=5)
    x = torch.zeros((m, kk), device="cuda", dtype=torch.bfloat16)
    x[torch.arange(m), torch.arange(m) % kk] = 1
    for bn, bm in ((128, 128), (128, 256)):
        out = torch.full((m, n), float("nan"), device="cuda")
        launch(lib, x, (sm, pl, d), 5, out, bn, bm)
        torch.cuda.synchronize()
        want = ref.decompress_matmul_ref(x, sm, pl, d, 5)
        bad = (out != want).nonzero().tolist()
        print(f"[diagnose] tile {bm}x{bn}: {len(bad)} of {m * n} one-hot "
              f"outputs wrong", flush=True)
        wf = w.float()
        for r, c in bad[:12]:
            hits = (wf == out[r, c]).nonzero().tolist()
            print(f"[diagnose]   out[{r}, {c}] = {float(out[r, c]):.6g} "
                  f"(want W[{r % kk}, {c}]); equals W at {hits[:4]}",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", default="1024,256")
    ap.add_argument("--diagnose", action="store_true")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("prefill_probe.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import weights
    from repro_torch.kernels import decompress_matmul as D, ops, ref

    ops.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}", flush=True)
    libs = build_variants()
    if opts.diagnose:
        diagnose(libs["base"])
    cfg = get_config("qwen3-4b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = [int(v) for v in opts.m.split(",")]
    rows, sums = [], {}
    for (kk, n), count in cs.weight_shapes(cfg):
        w = (torch.randn((kk, n), generator=gen, device="cuda") * 0.02
             ).to(torch.bfloat16)
        pw = weights.pack_serving_params({"w": w}, backend="cuda")["w"]
        fields = (pw.signman, pw.planes, pw.dict_syms)
        for m in ms:
            x = torch.randn((m, kk), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            out = torch.empty((m, n), device="cuda")
            want = ref.decompress_matmul_ref(x, *fields, pw.k)
            tol = 1e-4 * (x.float().abs() @ w.float().abs()) + 1e-6
            chosen = D.plan(m, kk, n, pw.k)
            for bm, bn in D.PREFILL_TILES:
                row = dict(K=kk, N=n, M=m, count=count, bm=bm, bn=bn,
                           chosen=(bm, bn) == (chosen.mrows, chosen.bn))
                for name, lib in libs.items():
                    fn = lambda: launch(lib, x, fields, pw.k, out, bn, bm)
                    try:
                        fn()
                    except RuntimeError:         # not a tile of the variant
                        row[name] = None
                        continue
                    torch.cuda.synchronize()
                    if name == "base":
                        err = (out - want).abs()
                        row["ok"] = bool((err <= tol).all())
                        row["max_abs_err"] = float(err.max())
                    row[name] = cs.cuda_ms(fn)
                rows.append(row)
                print(f"[probe] {row}", flush=True)
                if row["chosen"] and count > 1:
                    for name in libs:
                        t = row[name] if row[name] is not None \
                            else float("nan")
                        sums[(m, name)] = sums.get((m, name), 0.0) + count * t
            del want, tol, x, out
        del w, pw, fields
        torch.cuda.empty_cache()
    for (m, name), t in sorted(sums.items()):
        print(f"[pass] M={m} {name}: the 252 block matmuls on the plan's "
              f"tiles sum to {t:.3f} ms", flush=True)
    rec = dict(card=card, rows=rows,
               sums={f"M{m}_{name}": t for (m, name), t in sums.items()})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "prefill_probe.jsonl", "a") as f:
        f.write(json.dumps(rec) + "\n")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        print(f"[probe] {len(bad)} shapes/tiles disagree with the plain "
              f"version", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
