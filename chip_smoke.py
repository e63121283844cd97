#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits
non-zero:

  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build   — compile the CUDA kernels from ``src/repro_torch/csrc`` into
               one library (one nvcc per source, in parallel, then a link);
               print each kernel's registers, spills and static shared
               memory (ptxas -v), and check that every instantiation of
               ``decompress_matmul``'s prefill route has HGMMA (wgmma) in
               its SASS (cuobjdump -sass).
  3. kernels — each kernel against its plain PyTorch version at the main
               path's shapes (qwen3-4b pages: block 256, W 2048, k 5;
               4 slots of 300..2000 tokens), including pages with escapes
               and with escape overflow; exact equality for the histogram
               and the pack, rtol = atol = 1e-4 for paged attention.
               The two codec kernels also at the shapes of the encoder's
               other callers (``CODEC_SHAPES``: a ring flush's page, the
               fixed store's 3 records, the largest stacked weight leaf),
               exact, each timed with and without the spin, after a clean
               L2, and by the host's time per call, beside its bound and a
               ``Tensor.copy_`` of the same input; then one
               ``fixed.compress_many`` of 1 and of 16 pages, whole and by
               part (the two kernels, the dictionary, the escape side
               channel).
               The weight plane's kernels at qwen3-4b's weight shapes:
               ``lexi_unpack`` exact on one packed stacked leaf (36, 2560 x
               9728) and on the pool pages (``ops.unpack`` equal to
               ``fixed.decompress`` with escapes and overflow);
               ``decompress_matmul`` at the six (K, N) weight shapes with
               M = 4 (its split-K decode route) and 1024 (its prefill
               route), elementwise within 1e-4 * (|x| @ |W|) + 1e-6 and
               two launches bit for bit, each with its plan (route, tile,
               splits, CTAs, shared memory) and the host's time per call
               of both weight kernels; one 1024-token prefill's 252 block
               matmuls summed beside torch.mm's and the bound; then the M
               sweep: both routes at M = 1 .. 256, one decode step's
               matmuls summed: the decode route must be no slower at
               every slot count (M <= 64), and the largest M where it is
               no slower is printed beside the plan's threshold
               (DECODE_MAX_M).  The fixed-batch
               ``decode_attend`` at qwen3-4b's attention shapes (4
               sequences of 1100 tokens, block 256, k 5; full, window 700,
               softcap, codec off, a block whose escapes overflow inside
               sequence 2) and at gemma2-9b's (H 16/8, hd 256, 4400
               tokens, window 4096, softcap 50), within 1e-4, in both its
               launch forms: the length from the host, and the length a
               device int32 with the grid the store's capacity (the form
               the decode loop and its CUDA graph run; timed).  Both
               attention kernels split each stream into spans of P = 128
               rows across CTAs and merge in the kernel: their split edge
               cases (lengths 0, 1, P - 1, P, P + 1, blk, blk + 1, 2 blk;
               a window leaving only the last span; escapes on both sides
               of a span boundary in a page and in a fixed block's
               sequence 2, with overflow; 1 and 64 slots) within 1e-4,
               and two launches bit for bit; each kernel's grid (nsplit,
               CTAs, threads), registers and spills (``ptxas -v``) and
               shared memory per CTA.  Times each
               (CUDA events, median, L2 flushed and the card held by a
               spin before each launch, so the events bracket the kernel
               alone); the two attention kernels and their SDPA
               yardsticks also without the spin (the events then count the
               host's time to launch too) and by the host's time per call.
               The two weight kernels' JSON rows are one decode step's 253
               weight matmuls (7 per layer and the LM head) at M = 4,
               summed.
  4. small   — a tiny dense model decoded on the card and on the CPU from
               the same weights and tokens, raw and packed weights: logits
               agree within 1e-2.
  5. serve   — ServeEngine on full-width qwen3-4b (random weights from a
               seed), eagerly (``cuda_graphs=False``: the flush check reads
               the card inside the step): 6 mixed requests over 4 slots,
               pages filled at prefill and by ring flushes in replay and
               decode.  Every request must get its budget and every kernel
               must have launched.  In the last layer, every page a ring
               flush wrote during the run must decode back, bit for bit, to
               its ring, whose rows appended in the run must be the K/V the
               decode and replay steps produced; so must the pages of four
               fresh prefills, against the K/V of the model's forward pass.
  6. graphs  — the same mix from CUDA graphs (the engine's default on the
               card): streams, page table, page use and every byte of the
               pool's pages and rings equal to the eager run's; every
               eager step a flushing one and no other, the rest replayed,
               the paged kernel launched once per layer and step.  The mix
               again eagerly without the check (tok/s, TTFT of both).
               Then 8 decode steps of the 4 fresh slots, eagerly and from
               the graph, under torch.profiler: host ms per step, device
               busy ms per step and share, tokens/s, kernels and host
               launch calls per step, eager and replayed steps, the
               attention kernel's share and the top kernels (full tables
               in ``chiprun_out/profile_decode{,_graph}.txt``); and one
               flushing step timed on its own beside a replayed step and
               an eager step without a flush.
  7. fixed   — the fixed-batch loop (``engine.prefill`` +
               ``engine.decode_step``, the launcher's default mode) on the
               serve phase's weights: 4 prompts of 1000 tokens, 40 greedy
               steps at block 256, so the rings flush at 1024.  Each
               layer's ``decode_attend`` launches once per step; the
               flushed block of layers 0 and 35 decodes bit for bit to its
               ring; the codec off (raw blocks) gives the same tokens.
               The loop as ``generate`` runs it (``engine.FixedDecoder``),
               eagerly and from a CUDA graph: the same tokens, block stores
               and rings byte for byte, only the flushing step eager.
               Prints tokens/s and ms per decode step, then 8 steps under
               the profiler, eager and from the graph
               (``chiprun_out/profile_decode_fixed{,_graph}.txt``),
               how many tokens equal ``ServeEngine``'s on the same prompts
               and, at each sequence's first divergence, the top-2 logit
               margin of both paths and the largest gap between their
               logits (the ServeEngine path teacher-forced with the fixed
               loop's tokens), and the host time per step of the fixed and
               the paged loop in turns on the same sequences.
  8. weights — the serve phase's full-width weights packed on the card
               (time, each packed leaf's k, ``weight_plane_bytes``); the
               packed fields of ``blocks.mlp.w_gate`` and ``lm_head``
               byte-identical to the same leaves packed on the CPU; then
               the launcher's tail-free demo mix (6 requests over 4 slots,
               prompts 1024/512, budgets 32/16) served three ways: raw
               weights, ``weight_backend="unpack"`` (streams must equal the
               raw ones) and ``"cuda"`` (its share of tokens equal to the
               raw run and its first divergence are printed, with the
               top-2 logit margin and the largest logit gap of the two
               weight stores there, the raw run's tokens teacher-forced
               through both); tok/s and TTFT mean/p50/p95 of each, all
               three from CUDA graphs; then ``cuda`` eagerly, whose
               streams, page table and pool bytes the graph run must
               equal.  Every request gets its budget; both weight kernels
               launch; the ``cuda`` run's admissions make 252
               prefill-route launches each
               (``decompress_matmul.launches_by_route``).
               Last, the serve phase's 4 slots decode 8 steps from the
               packed store under the profiler, eagerly and from the
               graph, as in phase 6
               (``chiprun_out/profile_decode_packed{,_graph}.txt``).
  9. the card's line, the ``kernels`` JSON line (launches from the runs
     from CUDA graphs, the replays counted), then the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM bf16 tensor cores, dense
REPLACES = {"decode_attend_paged": "src/repro/kernels/decode_attend.py:421",
            "exp_histogram": "src/repro/kernels/exp_histogram.py:47",
            "lexi_pack": "src/repro/kernels/lexi_pack.py:56",
            "decompress_matmul": "src/repro/kernels/decompress_matmul.py:86",
            "lexi_unpack": "src/repro/kernels/lexi_unpack.py:51",
            "decode_attend": "src/repro/kernels/decode_attend.py:305"}
SERVE_KERNELS = ("decode_attend_paged", "exp_histogram", "lexi_pack")
ATTEND_KERNELS = ("decode_attend_paged", "decode_attend")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3, spin: bool = True,
            clean: bool = False) -> float:
    """Median device time of ``fn`` in ms; the 50 MB L2 is flushed before
    every timed launch (the decode path meets its pages cold).  With
    ``spin``, a 1-million-cycle spin on the card after the flush lets the
    host enqueue ``fn`` before the first event is reached, so the host's
    own time to launch (the wrapper's checks, ctypes) is not counted;
    without it, that time is counted wherever it exceeds the flush's.
    The flush writes 96 MB, so ``fn`` finds the L2 full of dirty lines,
    which its own misses write back to memory; with ``clean``, the flush
    reads the 96 MB instead and ``fn`` finds the L2 full of clean lines."""
    import torch
    flush = torch.zeros(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        if clean:
            flush.view(torch.int64).max()
        else:
            flush.zero_()
        if spin:
            torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def host_us(fn, calls: int = 100) -> float:
    """The host's time per call of ``fn`` in microseconds (enqueue only:
    the card is synchronised before and after, not between calls)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def attend_timing(name: str, fn, lib_fn):
    """An attention kernel's and its SDPA yardstick's time, both ways (with
    the spin: device time, the JSON line's; without: as the events read
    when the host's launch is slower than the L2 flush), and the host's
    time per call of each."""
    t = dict(ms=cuda_ms(fn), library_ms=cuda_ms(lib_fn),
             ms_no_spin=cuda_ms(fn, spin=False),
             library_ms_no_spin=cuda_ms(lib_fn, spin=False),
             host_us=host_us(fn), library_host_us=host_us(lib_fn))
    log("kernels", f"{name} timing: with the spin {t['ms']:.4f} ms (SDPA "
                   f"{t['library_ms']:.4f}); without it {t['ms_no_spin']:.4f}"
                   f" ms (SDPA {t['library_ms_no_spin']:.4f}); host time per "
                   f"call {t['host_us']:.1f} us (SDPA "
                   f"{t['library_host_us']:.1f})")
    return t


def device_phase():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("device", f"{smi} | torch {torch.__version__} cuda "
                  f"{torch.version.cuda} | {torch.cuda.device_count()} "
                  f"device(s)")
    return smi


def build_phase():
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    times = ops.build()
    log("build", f"{ops.LIBRARY.name} from {len(ops.SOURCES)} sources in "
                 f"{time.perf_counter() - t0:.1f}s (one nvcc per source in "
                 f"parallel, then one link: " + ", ".join(
                     f"{k} {v:.1f}s" for k, v in times.items()) + ")")
    for name in ops.KERNELS + ("decompress_matmul_prefill",):
        log("build", f"{name}: " + ", ".join(
            f"{kern}<{','.join(map(str, args))}> {r['registers']} registers, "
            f"spills {r['spill_stores']}/{r['spill_loads']} B, "
            f"{r['smem']} B static shared memory"
            for (kern, args), r in sorted(ptxas_report(name).items())))
    hgmma = sass_count("prefill_kernel", "HGMMA")
    assert hgmma and min(hgmma.values()) > 0, hgmma
    log("build", f"decompress_matmul's prefill route: HGMMA (wgmma) in the "
                 f"SASS of all {len(hgmma)} prefill_kernel instantiations "
                 f"({min(hgmma.values())}-{max(hgmma.values())} each; "
                 f"cuobjdump -sass {ops.LIBRARY.name})")
    ops.library()


def sass_count(kernel: str, opcode: str):
    """{function: instructions of ``opcode``} over the functions of the
    built library whose name contains ``kernel`` (cuobjdump -sass)."""
    import re
    from repro_torch.kernels import ops
    tool = Path(ops.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(ops.LIBRARY)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    return counts


def ptxas_report(name: str):
    """{(kernel, template arguments): {registers, spill_stores,
    spill_loads, smem}} of a source's instantiations from its ``ptxas -v``
    log; an attention kernel's argument is k (0: codec off), the weight
    kernels' are k and, for decompress_matmul's decode route, the column
    tile (its prefill route: k and the m64 tiles per consumer
    warpgroup).  ``smem``: static shared memory (the decode and prefill
    routes' is dynamic, printed per launch)."""
    import re
    from repro_torch.kernels import ops
    out, key = {}, None
    for line in (ops.build_log(name) or "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:                      # <length><name>kernel[I(Li<arg>E)+E]
            key = None
            for km in re.finditer(r"(?=(\d+)([A-Za-z_]\w*?kernel))",
                                  m.group(1)):
                if int(km.group(1)) == len(km.group(2)):
                    end = km.start() + len(km.group(1)) + len(km.group(2))
                    args = re.match(r"I((?:Li\d+E)+)E", m.group(1)[end:])
                    key = (km.group(2), tuple(
                        int(v) for v in re.findall(r"Li(\d+)E", args.group(1))
                    ) if args else ())
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(key, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[key]["smem"] = int(sm.group(1)) if sm else 0
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pages(gen, n_pages, blk, w):
    """K/V-like bf16 pages: normal values, one page with a moderate number
    of out-of-dictionary exponents (escapes within capacity) and one with
    far more distinct exponents than the side channel holds (overflow)."""
    import torch
    x = torch.randn((n_pages, blk, w), generator=gen, device="cuda")
    scale = torch.ones_like(x)
    wide = torch.rand((blk, w), generator=gen, device="cuda")
    scale[1] = torch.where(wide < 0.004, 2.0 ** 40, 1.0)        # escapes
    scale[2] = torch.exp2(torch.randint(-60, 60, (blk, w), generator=gen,
                                        device="cuda").float())  # overflow
    return (x * scale).to(torch.bfloat16)


def paged_case(gen, h, hd, n_pages, blk, w, lengths):
    """The timed paged case's q, ring, page table (clipped) and lengths:
    the slots walk a permutation of the pool's pages, except that the
    longest (last) slot's first two pages are 1 and 2."""
    import torch
    s_ = len(lengths)
    maxp = max(L // blk for L in lengths) + 1
    perm = torch.randperm(n_pages, generator=gen, device="cuda").cpu()
    perm = [p for p in perm.tolist() if p not in (1, 2)]
    table = torch.full((s_, maxp), -1, dtype=torch.int32)
    nxt = 0
    for si, L in enumerate(lengths):
        for i in range(L // blk):
            if si == s_ - 1 and i < 2:
                table[si, i] = i + 1                # pages 1, 2
            else:
                table[si, i] = perm[nxt]
                nxt += 1
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = (torch.randn((s_, h, hd), generator=gen, device="cuda")
         ).to(torch.bfloat16)
    ring = torch.randn((s_, blk, w), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    return q, ring, table.clamp(min=0).cuda(), lens


def fixed_rows(blocks, ring, length):
    """A fixed-batch store's K/V rows below ``length``, decompressed:
    (B, length, W) from blocks (nblk, B, blk, W) and the ring."""
    import torch
    blk = ring.shape[1]
    live = length // blk
    dec = blocks[:live].transpose(0, 1).reshape(ring.shape[0], live * blk, -1)
    return torch.cat([dec, ring[:, :length - live * blk]], 1)


def sdpa_fn(q, rows):
    """The yardstick the port never calls: one SDPA (``enable_gqa``) call
    of q (S, H, hd) over K/V rows (S, T, Hkv * 2 * hd) already
    decompressed."""
    import torch
    s_, t, w = rows.shape
    hd = q.shape[-1]
    kv = rows.reshape(s_, t, w // (2 * hd), 2, hd)
    kk, vv = kv[..., 0, :].transpose(1, 2), kv[..., 1, :].transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kk, vv, enable_gqa=True)


# the encoder's callers' shapes (rows x elements): a decode-step ring
# flush (one page), chip_smoke's 16-page table, the fixed batch's store
# (up to 3 records), the largest stacked weight leaf (36 x 2560 x 9728)
CODEC_SHAPES = (("flush", 1, 524288), ("table", 16, 524288),
                ("fixed", 3, 2097152), ("leaf", 36, 24903680))


def codec_bounds(g: int, n: int, k: int):
    """The two codec kernels' bounds in ms: the histogram reads 2 bytes an
    element; the pack reads 2 and writes 1 + k/8."""
    return {"exp_histogram": 2 * g * n / HBM_BYTES_PER_S * 1e3,
            "lexi_pack": (3 + k / 8) * g * n / HBM_BYTES_PER_S * 1e3}


def codec_inputs(gen, pages):
    """(name, x) for CODEC_SHAPES: the first two from ``pages`` (16 K/V-like
    pages, with escapes and overflow), the store K/V-like, the leaf
    N(0, 0.02) like the weights."""
    import torch
    for name, g, n in CODEC_SHAPES:
        if name in ("flush", "table"):
            x = pages[:g]
        else:
            x = torch.randn((g, n), generator=gen, device="cuda")
            if name == "leaf":
                x = x * 0.02
            x = x.to(torch.bfloat16)
        assert tuple(x.shape) == (g, n), (name, x.shape)
        yield name, x


def codec_check(name, x, k):
    """Both codec kernels on x bit for bit against the plain versions;
    rows 0 and -1 alone where the plain versions do not fit on the card."""
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import ops, ref
    hist = ops.histogram(x)
    lut = fixed.build_dictionary(hist, k)[1]
    sm, pl = ops.pack(x, lut, k)
    try:
        sel = slice(None)
        want = ref.histogram_ref(x)
        sm_p, pl_p = ref.pack_ref(x, lut, k)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        sel = [0, x.shape[0] - 1]
        want = ref.histogram_ref(x[sel])
        sm_p, pl_p = ref.pack_ref(x[sel], lut[sel], k)
    assert torch.equal(hist[sel], want), f"exp_histogram != plain ({name})"
    assert torch.equal(sm[sel], sm_p) and torch.equal(pl[sel], pl_p), \
        f"lexi_pack != plain ({name})"
    del want, sm_p, pl_p, sm, pl
    torch.cuda.empty_cache()
    return "all rows" if sel == slice(None) else "rows 0 and -1 (plain OOM)"


def codec_timing(x, k):
    """Both codec kernels on x: ms with and without the spin, with the
    spin after a clean flush, the host's us per call, and the bound; and,
    as a yardstick of what streaming x costs at this size, one
    ``Tensor.copy_`` of x (reads and writes 2 bytes an element) timed
    both ways."""
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import ops
    lut = fixed.build_dictionary(ops.histogram(x), k)[1]
    bounds = codec_bounds(*x.shape, k)
    out = {}
    for kern, fn in (("exp_histogram", lambda: ops.histogram(x)),
                     ("lexi_pack", lambda: ops.pack(x, lut, k))):
        out[kern] = dict(ms=cuda_ms(fn), ms_no_spin=cuda_ms(fn, spin=False),
                         ms_clean=cuda_ms(fn, clean=True),
                         host_us=host_us(fn), bound_ms=bounds[kern])
    dst = torch.empty_like(x)
    out["copy"] = dict(ms=cuda_ms(lambda: dst.copy_(x)),
                       ms_clean=cuda_ms(lambda: dst.copy_(x), clean=True),
                       bound_ms=4 * x.numel() / HBM_BYTES_PER_S * 1e3)
    return out


def codec_shapes(gen, pages, k):
    """exp_histogram and lexi_pack at CODEC_SHAPES: exact, then timed."""
    shapes = {}
    for name, x in codec_inputs(gen, pages):
        how = codec_check(name, x, k)
        shapes[name] = t = codec_timing(x, k)
        cp = t["copy"]
        log("kernels", f"codec {name} {tuple(x.shape)} k={k}: exact against "
                       f"the plain versions ({how}); " + "; ".join(
                           f"{kern} {r['ms']:.5f} ms (no spin "
                           f"{r['ms_no_spin']:.5f}, clean L2 "
                           f"{r['ms_clean']:.5f}, host {r['host_us']:.1f} "
                           f"us, bound {r['bound_ms']:.5f}, "
                           f"{r['bound_ms'] / r['ms']:.0%} of it)"
                           for kern, r in t.items() if kern != "copy")
                       + f"; yardstick Tensor.copy_ {cp['ms']:.5f} ms (clean "
                       f"L2 {cp['ms_clean']:.5f}, bound {cp['bound_ms']:.5f})")
        del x
    return shapes


def compress_share(pages, k, c):
    """One fixed.compress_many of 1 and of 16 pages, timed whole and by
    part: the two kernels, the dictionary build and the rest (the escape
    side channel's torch ops), with the spin; and the whole without it
    and by the host's time per call."""
    from repro_torch.core import fixed
    from repro_torch.kernels import ops
    out = {}
    for g in (1, pages.shape[0]):
        x = pages[:g]
        hist = ops.histogram(x)
        lut = fixed.build_dictionary(hist, k)[1]
        fn = lambda: fixed.compress_many(x, k=k, esc_capacity=c)
        t = dict(ms=cuda_ms(fn), ms_no_spin=cuda_ms(fn, spin=False),
                 host_us=host_us(fn),
                 exp_histogram=cuda_ms(lambda: ops.histogram(x)),
                 build_dictionary=cuda_ms(
                     lambda: fixed.build_dictionary(hist, k)),
                 lexi_pack=cuda_ms(lambda: ops.pack(x, lut, k)))
        t["rest"] = t["ms"] - t["exp_histogram"] - t["build_dictionary"] \
            - t["lexi_pack"]
        out[g] = t
        log("kernels", f"compress_many ({g} x {x.shape[1]}, k={k}): "
                       f"{t['ms']:.5f} ms (no spin {t['ms_no_spin']:.5f}, "
                       f"host {t['host_us']:.1f} us/call); exp_histogram "
                       f"{t['exp_histogram']:.5f} + lexi_pack "
                       f"{t['lexi_pack']:.5f} = "
                       f"{(t['exp_histogram'] + t['lexi_pack']) / t['ms']:.1%}"
                       f"; build_dictionary {t['build_dictionary']:.5f} "
                       f"({t['build_dictionary'] / t['ms']:.1%}); the rest "
                       f"(escape side channel) {t['rest']:.5f} "
                       f"({t['rest'] / t['ms']:.1%})")
    return out


def kernels_phase(cfg):
    import torch
    from repro_torch.core import entropy as E
    from repro_torch.core import fixed
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.kernels import decode_attend, ops, ref
    from repro_torch.models import cache as cache_mod

    gen = torch.Generator(device="cuda").manual_seed(0)
    blk, hd, hkv, h = 256, cfg.head_dim, cfg.n_kv_heads, cfg.n_heads
    w = 2 * hkv * hd
    n, k = blk * w, 5
    c = max(n // 128, 8)
    lengths = [300, 700, 1100, 2000]
    s_ = len(lengths)
    n_live = sum(L // blk for L in lengths)
    n_pages = n_live + 2
    pages = _pages(gen, n_pages, blk, w)
    rows = pages.reshape(n_pages, n)
    rec = {}

    # exp_histogram and lexi_pack: exact, at the four shapes of the
    # encoder's callers; the JSON rows are the 16-page table's
    shapes = codec_shapes(gen, rows, k)
    want = ref.histogram_ref(rows)
    g = n_pages
    # yardstick: one torch.bincount over (row, exponent) keys; the exponent
    # field is extracted into the keys beforehand, outside the timing
    keys = (torch.arange(g, device="cuda")[:, None] * 256
            + E.exponent(E.to_u16(rows))).reshape(-1)
    assert torch.equal(torch.bincount(keys, minlength=g * 256)
                       .reshape(g, 256).to(torch.int32), want)
    table = shapes["table"]
    rec["exp_histogram"] = dict(
        max_abs_err=0, ms=table["exp_histogram"]["ms"],
        plain_ms=cuda_ms(lambda: ref.histogram_ref(rows), reps=5),
        bound_ms=table["exp_histogram"]["bound_ms"], bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.bincount(keys, minlength=g * 256)))
    del keys
    log("kernels", f"exp_histogram ({g} x {n}) exact: "
                   f"{rec['exp_histogram']}")
    _, enc_lut = fixed.build_dictionary(want, k)
    rec["lexi_pack"] = dict(
        max_abs_err=0, ms=table["lexi_pack"]["ms"],
        plain_ms=cuda_ms(lambda: ref.pack_ref(rows, enc_lut, k), reps=5),
        bound_ms=table["lexi_pack"]["bound_ms"], bound_by="bytes",
        library_ms=None)
    log("kernels", f"lexi_pack ({g} x {n}, k={k}) exact: "
                   f"{rec['lexi_pack']}")
    compress_share(rows, k, c)

    # the kernel-backed codec equals the CPU codec byte for byte
    ct = fixed.compress_many(pages, k=k, esc_capacity=c)
    ct_cpu = fixed.compress_many(pages.cpu(), k=k, esc_capacity=c)
    for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
              "n_escapes"):
        assert torch.equal(getattr(ct, f).cpu(), getattr(ct_cpu, f)), f
    n_esc = ct.n_escapes.cpu().tolist()
    assert n_esc[1] > 0 and n_esc[1] <= c and n_esc[2] > c, n_esc
    log("kernels", f"compress on the card == compress on the CPU "
                   f"(escapes per page {n_esc[:4]}..., capacity {c})")

    # decode_attend_paged: slots walk permuted pages; the escape and
    # overflow pages are live in the longest slot
    q, ring, page_ids, lens = paged_case(gen, h, hd, n_pages, blk, w,
                                         lengths)
    maxp = page_ids.shape[1]
    fields = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
              None)
    kv_idx = cache_mod.gqa_head_table(cfg, h)
    scale = hd ** -0.5
    errs = []
    for window in (ref.WINDOW_NONE, 700):
        args = (q, *fields, ring, page_ids, lens, window)
        o_k, m_k, l_k = decode_attend.decode_attend_paged(
            *args, k=k, kv_idx=kv_idx, scale=scale)
        o_p, m_p, l_p = ref.paged_decode_attend_plain(
            *args, k=k, kv_idx=kv_idx, scale=scale)
        a = o_k / l_k.clamp(min=1e-30)[..., None]
        b = o_p / l_p.clamp(min=1e-30)[..., None]
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        errs.append(float((a - b).abs().max()))
    # codec off: raw bf16 pages through the same kernel
    raw = (None,) * 5 + (fixed.decompress(ct),)
    args_raw = (q, *raw, ring, page_ids, lens, ref.WINDOW_NONE)
    o_k, _, l_k = decode_attend.decode_attend_paged(
        *args_raw, k=k, kv_idx=kv_idx, scale=scale)
    o_p, _, l_p = ref.paged_decode_attend_plain(*args_raw, k=k,
                                                kv_idx=kv_idx, scale=scale)
    torch.testing.assert_close(o_k / l_k[..., None], o_p / l_p[..., None],
                               rtol=1e-4, atol=1e-4)

    args = (q, *fields, ring, page_ids, lens, ref.WINDOW_NONE)
    kw = dict(k=k, kv_idx=kv_idx, scale=scale)
    first = decode_attend.decode_attend_paged(*args, **kw)
    assert AC.same_bits(first, decode_attend.decode_attend_paged(*args, **kw)), \
        "decode_attend_paged: two launches differ"
    grid_line("decode_attend_paged", h, hkv, hd, blk, s_,
              decode_attend.paged_splits(maxp, blk), k)
    errs.append(split_edges_paged(cfg, gen))
    # yardstick: one library call (SDPA, GQA) on already-decompressed
    # pages gathered per slot; the port never calls it
    lib_fn = sdpa_fn(q, torch.cat(
        [raw[-1][page_ids.long()].reshape(s_, -1, w), ring], 1))
    ring_rows = sum(L % blk for L in lengths)
    page_bytes = n * (1 + k / 8) + c
    by = (n_live * page_bytes + ring_rows * w * 2 + q.numel() * 2
          + s_ * h * (hd + 2) * 4)
    flops = 4 * s_ * h * hd * sum(lengths)
    t_bytes, t_ops = by / HBM_BYTES_PER_S, flops / F32_FLOPS
    rec["decode_attend_paged"] = dict(
        max_abs_err=max(errs),
        plain_ms=cuda_ms(lambda: ref.paged_decode_attend_plain(
            *args, k=k, kv_idx=kv_idx, scale=scale), reps=5),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        **attend_timing("decode_attend_paged",
                        lambda: decode_attend.decode_attend_paged(*args, **kw),
                        lib_fn))
    log("kernels", f"decode_attend_paged (S={s_}, H={h}/{hkv}, hd={hd}, "
                   f"lengths {lengths}, {n_live} live pages) within 1e-4 "
                   f"(full + window 700 + codec off + split edges), two "
                   f"launches bit for bit: {rec['decode_attend_paged']}")
    rec.update(weight_kernels(cfg, ct, gen))
    rec["decode_attend"] = fixed_attend_kernel(cfg, gen)
    return rec


def grid_line(name, h, hkv, hd, blk, n_seq, nsplit, k):
    """Log a kernel's launch: grid, threads, chunk rows, shared memory per
    CTA, and registers and spills of its k instantiation (ptxas -v)."""
    from repro_torch.kernels import decode_attend
    span = decode_attend.span_rows(blk)
    geo = decode_attend.geometry(hd, h - (hkv - 1) * (h // hkv), span)
    regs = next((r for (_, args), r in ptxas_report(name).items()
                 if args == (k,)), {})
    log("kernels", f"{name} launch at H={h}/{hkv}, hd={hd}: nsplit {nsplit} "
                   f"(P={span} rows), grid {hkv} x {n_seq} x {nsplit} = "
                   f"{hkv * n_seq * nsplit} CTAs of {geo['threads']} "
                   f"threads, chunks of {geo['chunk_rows']} rows, "
                   f"{geo['smem_bytes']} B shared memory per CTA, "
                   f"{regs.get('registers')} registers, spills "
                   f"{regs.get('spill_stores')}/{regs.get('spill_loads')} B "
                   f"(k={k})")


def split_edges_paged(cfg, gen):
    """The paged kernel's split edge cases at qwen3-4b's heads, block 256
    (P = 128): slot lengths at span and block edges, a window leaving only
    the last span, a page with escapes on rows P - 1 and P and one past
    its capacity; then 1 and 64 slots.  Every call within 1e-4 and
    bit-identical on a second launch."""
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.kernels import decode_attend, ref

    blk, k = 256, 5
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = 2 * hkv * hd
    p = decode_attend.span_rows(blk)
    kw = dict(k=k, kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5)
    pages = (torch.randn((24, blk, w), generator=gen, device="cuda")
             ).to(torch.bfloat16)
    pages[0] = AC.overflowing(gen, (blk, w))
    pages[1] = AC.with_escapes(AC.dict_filled(gen, (blk, w)), [p - 1, p])
    ct = fixed.compress_many(pages, k=k)
    rows = set((ct.esc_pos[1][:int(ct.n_escapes[1])] // w).tolist())
    assert int(ct.n_escapes[0]) > ct.esc_pos.shape[-1] and \
        {p - 1, p} <= rows, rows
    pool = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
            None)
    worst, n_calls = 0.0, 0
    for lengths in (AC.edge_lengths(blk), [3 * blk - 1],
                    [(i * 97 + 300) % (3 * blk) for i in range(64)]):
        s_ = len(lengths)
        maxp = max(lengths) // blk + 1
        table = torch.randint(0, 24, (s_, maxp), generator=gen,
                              device="cuda", dtype=torch.int32)
        longest = max(range(s_), key=lambda i: lengths[i])
        table[longest, :2] = torch.tensor([0, 1], dtype=torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn((s_, h, hd), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        ring = torch.randn((s_, blk, w), generator=gen, device="cuda"
                           ).to(torch.bfloat16)
        for window, softcap in ((ref.WINDOW_NONE, None), (700, None),
                                (5, None), (ref.WINDOW_NONE, 50.0)):
            args = (q, *pool, ring, table, lens, window)
            got = decode_attend.decode_attend_paged(*args, **kw,
                                                    softcap=softcap)
            worst = max(worst, AC.attend_close(
                got, ref.paged_decode_attend_plain(*args, **kw,
                                                   softcap=softcap)))
            assert AC.same_bits(got, decode_attend.decode_attend_paged(
                *args, **kw, softcap=softcap)), "paged: launches differ"
            n_calls += 1
    log("kernels", f"decode_attend_paged split edges (P={p}, block {blk}): "
                   f"lengths {AC.edge_lengths(blk)}, 1 slot, 64 slots; full, "
                   f"window 700, window 5 (last span only), softcap 50; "
                   f"escapes on rows {p - 1} and {p} of a page and past the "
                   f"capacity of another: {n_calls} calls within 1e-4, each "
                   f"launched twice bit for bit; max |err| {worst:.3e}")
    return worst


def split_edges_fixed(cfg, gen):
    """The fixed kernel's split edge cases at qwen3-4b's heads, block 256,
    3 sequences: the lengths of ``attend_cases.edge_lengths``, full / window 5 /
    window 700 / softcap; block 1 holds escapes in sequence 0 and, in
    sequence 2, on rows P - 1 and P (within the capacity) followed by more
    than the capacity holds.  Within 1e-4, bit-identical twice."""
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.kernels import decode_attend, ref

    blk, k, b = 256, 5, 3
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = 2 * hkv * hd
    p = decode_attend.span_rows(blk)
    lengths = AC.edge_lengths(blk)
    nblk = max(lengths) // blk + 1
    blocks = torch.randn((nblk, b, blk, w), generator=gen, device="cuda"
                         ).to(torch.bfloat16)
    blocks[1] = AC.dict_filled(gen, (b, blk, w))
    blocks[1, 0] = AC.with_escapes(blocks[1, 0], list(range(1, blk, 5)))
    blocks[1, 2] = AC.with_escapes(blocks[1, 2], [p - 1, p])
    over = list(range(p + 3, blk))
    blocks[1, 2, over] = torch.exp2(torch.randint(
        -90, -50, (len(over), w), generator=gen, device="cuda").float()
    ).to(torch.bfloat16)
    n = b * blk * w
    ct = fixed.compress_many(blocks.reshape(nblk, n), k=k,
                             esc_capacity=max(n // 128, 8))
    seq2 = ((ct.esc_pos[1][ct.esc_pos[1] < n] - 2 * blk * w) // w).tolist()
    assert int(ct.n_escapes[1]) > ct.esc_pos.shape[-1]
    assert {p - 1, p} <= set(seq2), "no escapes around the span edge"
    store = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
             None)
    q = torch.randn((b, h, hd), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    ring = torch.randn((b, blk, w), generator=gen, device="cuda"
                       ).to(torch.bfloat16)
    kw = dict(k=k, kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5)
    dev_len = torch.zeros((), dtype=torch.int32, device="cuda")
    worst, n_calls, same = 0.0, 0, 0
    for length in lengths:
        dev_len.fill_(length)
        for window, softcap in ((ref.WINDOW_NONE, None), (700, None),
                                (5, None), (ref.WINDOW_NONE, 50.0)):
            args = (q, *store, ring, length, window)
            want = ref.decode_attend_plain(*args, **kw, softcap=softcap)
            host = None
            # the host-length launch, then the device-length one (the
            # length read on the card, the grid the store's capacity)
            for form in (length, dev_len):
                args = (q, *store, ring, form, window)
                got = decode_attend.decode_attend(*args, **kw,
                                                  softcap=softcap)
                worst = max(worst, AC.attend_close(got, want))
                assert AC.same_bits(got, decode_attend.decode_attend(
                    *args, **kw, softcap=softcap)), "fixed: launches differ"
                n_calls += 1
                if host is None:
                    host = got
                else:
                    AC.attend_close(got, host)
                    same += AC.same_bits(got, host)
    log("kernels", f"decode_attend split edges (P={p}, block {blk}, B={b}): "
                   f"lengths {lengths}; full, window 700, window 5, softcap "
                   f"50; sequence 2 escapes on rows {p - 1} and {p} and past "
                   f"the capacity; host-length and device-length launches "
                   f"({decode_attend.capacity_splits(nblk, blk)} splits): "
                   f"{n_calls} calls within 1e-4, each launched twice bit "
                   f"for bit; the two forms within 1e-4 of each other, "
                   f"bit for bit in {same}/{n_calls // 2}; max |err| "
                   f"{worst:.3e}")
    return worst


def _fixed_blocks(gen, nblk, b, blk, w):
    """(nblk, B, blk, W) K/V-like bf16 blocks; block 1 has a few escapes
    in sequence 0 and more distinct exponents than the block's side
    channel holds in sequence 2 (small values, so that the attention
    outputs stay O(1) and an absolute error means something)."""
    import torch
    x = torch.randn((nblk, b, blk, w), generator=gen, device="cuda")
    rare = torch.rand((blk, w), generator=gen, device="cuda") < 0.004
    x[1, 0] = torch.where(rare, x[1, 0] * 2.0 ** -40, x[1, 0])
    x[1, 2] = x[1, 2] * torch.exp2(torch.randint(
        -90, 1, (blk, w), generator=gen, device="cuda").float())
    return x.to(torch.bfloat16)


def _fixed_case(gen, b, h, hkv, hd, blk, length, k=5):
    """The kernel's arguments at one attention shape: a store of
    length // blk + 1 blocks (the last one dead), its ring and q."""
    import torch
    from repro_torch.core import fixed

    w = 2 * hkv * hd
    nblk = length // blk + 1
    blocks = _fixed_blocks(gen, nblk, b, blk, w)
    n = b * blk * w
    ct = fixed.compress_many(blocks.reshape(nblk, n), k=k,
                             esc_capacity=max(n // 128, 8))
    ring = torch.randn((b, blk, w), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    q = torch.randn((b, h, hd), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    return blocks, ct, ring, q


def _fixed_check(args_codec, args_raw, kw_cases):
    """Kernel against plain version, normalised, within 1e-4, for every
    (args, kwargs) case, the host-length and the device-length launch;
    returns the largest |error|."""
    import torch
    from repro_torch.kernels import decode_attend, ref

    worst = 0.0
    for codec_on, kw, window in kw_cases:
        args = (args_codec if codec_on else args_raw) + (window,)
        o_p, _, l_p = ref.decode_attend_plain(*args, **kw)
        b = o_p / l_p.clamp(min=1e-30)[..., None]
        dev = torch.tensor(args[-2], dtype=torch.int32, device="cuda")
        for form in (args, args[:-2] + (dev, window)):    # both launches
            o_k, _, l_k = decode_attend.decode_attend(*form, **kw)
            a = o_k / l_k.clamp(min=1e-30)[..., None]
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
            worst = max(worst, float((a - b).abs().max()))
    return worst


def fixed_attend_kernel(cfg, gen):
    """decode_attend against its plain version at qwen3-4b's and
    gemma2-9b's attention shapes, timed at qwen3-4b's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.kernels import decode_attend, ref

    b, blk, k = 4, 256, 5
    errs = []
    for arch, length, window, softcap in (("qwen3-4b", 1100, 700, 50.0),
                                          ("gemma2-9b", 4400, 4096, 50.0)):
        c_ = cfg if arch == cfg.name else get_config(arch)
        h, hkv, hd = c_.n_heads, c_.n_kv_heads, c_.head_dim
        blocks, ct, ring, q = _fixed_case(gen, b, h, hkv, hd, blk, length)
        cap = ct.esc_pos.shape[-1]
        n_esc = ct.n_escapes.tolist()
        assert n_esc[1] > cap, n_esc                          # overflow
        assert bool((ct.esc_pos[1] < blk * 2 * hkv * hd).any())
        kw = dict(k=k, kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5)
        store = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos,
                 ct.esc_raw, None)
        args = (q, *store, ring, length)
        args_raw = (q, *(None,) * 5, blocks, ring, length)
        full, win = ref.WINDOW_NONE, window
        cases = [(True, kw, full), (True, kw, win),
                 (True, dict(kw, softcap=softcap), full),
                 (True, dict(kw, softcap=softcap), win),
                 (False, kw, full), (False, dict(kw, softcap=softcap), win)]
        errs.append(_fixed_check(args, args_raw, cases))
        log("kernels", f"decode_attend at {arch}'s shapes (B={b}, H={h}/"
                       f"{hkv}, hd={hd}, block {blk}, length {length}, "
                       f"{length // blk} live blocks, escapes per block "
                       f"{n_esc[:3]}..., capacity {cap}) within 1e-4: full, "
                       f"window {window}, softcap {softcap}, codec off; "
                       f"host-length and device-length launches; "
                       f"max |err| {errs[-1]:.3e}")
        if arch != cfg.name:
            del blocks, ct, ring, q, store, args, args_raw
            torch.cuda.empty_cache()
            continue
        # timed: the device-length launch, as the decode loop runs it
        # (its grid the store's capacity: length // blk + 1 blocks and the
        # ring); the host-length launch logged beside it
        host_form = (args + (full,), kw)
        dev_len = torch.tensor(length, dtype=torch.int32, device="cuda")
        timed = ((q, *store, ring, dev_len, full), kw)
        for form in (host_form, timed):
            first = decode_attend.decode_attend(*form[0], **form[1])
            assert AC.same_bits(first, decode_attend.decode_attend(
                *form[0], **form[1])), "decode_attend: two launches differ"
        nblk = store[0].shape[0]
        grid_line("decode_attend", h, hkv, hd, blk, b,
                  decode_attend.fixed_splits(length, full, blk)[1], k)
        grid_line("decode_attend", h, hkv, hd, blk, b,
                  decode_attend.capacity_splits(nblk, blk), k)

        def host_fn():
            return decode_attend.decode_attend(*host_form[0], **host_form[1])

        log("kernels", f"decode_attend host-length launch (grid from the "
                       f"host length): {cuda_ms(host_fn):.4f} ms with the "
                       f"spin, host time per call {host_us(host_fn):.1f} us")
        errs.append(split_edges_fixed(cfg, gen))
        live = length // blk
        lib_fn = sdpa_fn(q, fixed_rows(blocks, ring, length))
        n = b * blk * 2 * hkv * hd
        by = (live * (n * (1 + k / 8) + (1 << k) + 5 * cap)
              + b * (length - live * blk) * 2 * hkv * hd * 2
              + q.numel() * 2 + b * h * (hd + 2) * 4)
        flops = 4 * b * h * hd * length
        t_bytes, t_ops = by / HBM_BYTES_PER_S, flops / F32_FLOPS
        row = dict(
            max_abs_err=None,
            plain_ms=cuda_ms(lambda: ref.decode_attend_plain(
                *timed[0], **timed[1]), reps=5),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            **attend_timing("decode_attend", lambda: decode_attend
                            .decode_attend(*timed[0], **timed[1]), lib_fn))
    row["max_abs_err"] = max(errs)
    log("kernels", f"decode_attend at qwen3-4b's shapes, full window, "
                   f"codec on, device-length launch: {row}")
    return row


def weight_shapes(cfg):
    """[((K, N), matmuls per decode step)] of the dense model's weights:
    wq, wk and wv, wo, w_gate and w_up, w_down per layer, and the LM
    head."""
    d, hd, layers = cfg.d_model, cfg.head_dim, cfg.n_layers
    q, kv, f = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff
    return [((d, q), layers), ((d, kv), 2 * layers), ((q, d), layers),
            ((d, f), 2 * layers), ((f, d), layers),
            ((d, cfg.padded_vocab(1)), 1)]


def weight_kernels(cfg, ct, gen):
    """lexi_unpack and decompress_matmul against their plain versions at
    qwen3-4b's weight shapes; ``ct`` are the pool pages of the codec
    checks above (with escapes and overflow)."""
    import torch
    from repro_torch.core import fixed, weights
    from repro_torch.kernels import decompress_matmul, lexi_unpack, ops, ref

    i16 = lambda t: t.view(torch.int16)
    bf16 = torch.bfloat16
    # lexi_unpack on the pool pages, and the kernel-backed decompress
    pages = (ct.signman, ct.planes, ct.dict_syms)
    assert torch.equal(i16(lexi_unpack.lexi_unpack(*pages, ct.k)),
                       i16(ref.unpack_ref(*pages, ct.k)))
    assert torch.equal(i16(ops.unpack(ct)), i16(fixed.decompress(ct)))
    log("kernels", f"lexi_unpack on {ct.signman.shape[0]} pool pages == "
                   f"plain; ops.unpack == fixed.decompress bit for bit "
                   f"(escapes per page {ct.n_escapes.tolist()[:3]}..., "
                   f"capacity {ct.esc_pos.shape[-1]})")

    # one stacked leaf packed on the card: unpacks to its bits, and to the
    # plain version's (row by row: the plain version's int64 temporaries)
    nl, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    w = (torch.randn((nl, d, f), generator=gen, device="cuda") * 0.02
         ).to(bf16)
    pw = weights.pack_serving_params({"blocks": {"w": w}},
                                     backend="cuda")["blocks"]["w"]
    assert isinstance(pw, weights.PackedWeight), "stacked leaf not packed"
    back = weights.unpack_weight(pw)
    assert torch.equal(i16(back), i16(w))
    for i in range(nl):
        row = ref.unpack_ref(pw.signman[i].reshape(1, -1),
                             pw.planes[i].reshape(1, pw.k, -1),
                             pw.dict_syms[i].reshape(1, -1), pw.k)
        assert torch.equal(i16(row), i16(back[i].reshape(1, -1)))
    log("kernels", f"lexi_unpack on a packed stacked leaf {tuple(w.shape)} "
                   f"(k={pw.k}, one launch of {nl} rows): exact, and equal "
                   f"to the plain version row by row")
    del w, back, pw

    dm = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, b_bytes=0.0,
              b_ops=0.0, max_abs_err=0.0, host_us=0.0)
    # one 1024-token prefill's 252 block matmuls (the LM head runs on the
    # last positions only, through the decode route)
    pre = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    un = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, host_us=0.0)
    packed = []                              # (pw, count) for the M sweep
    for (kk, n), count in weight_shapes(cfg):
        w = (torch.randn((kk, n), generator=gen, device="cuda") * 0.02
             ).to(bf16)
        pw = weights.pack_serving_params({"w": w}, backend="cuda")["w"]
        fields = (pw.signman, pw.planes, pw.dict_syms)
        for m in (4, 1024):
            x = torch.randn((m, kk), generator=gen, device="cuda").to(bf16)
            fn = lambda: decompress_matmul.decompress_matmul(x, *fields, pw.k)
            got = fn()
            again = fn()
            assert torch.equal(got.view(torch.int32),
                               again.view(torch.int32)), (kk, n, m)
            want = ref.decompress_matmul_ref(x, *fields, pw.k)
            tol = 1e-4 * (x.float().abs() @ w.float().abs()) + 1e-6
            err = (got - want).abs()
            assert bool((err <= tol).all()), (kk, n, m, float(err.max()))
            t = cuda_ms(fn)
            t_plain = cuda_ms(lambda: ref.decompress_matmul_ref(
                x, *fields, pw.k), reps=3)
            t_lib = cuda_ms(lambda: torch.mm(x, w, out_dtype=torch.float32))
            t_host = host_us(fn)
            t_bytes = (m * kk * 2 + pw.nbytes() + m * n * 4) \
                / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * m * n * kk / BF16_FLOPS * 1e3
            p = decompress_matmul.plan(m, kk, n, pw.k)
            smem_b = decompress_matmul.smem_bytes(p, pw.k)
            if p.route == "prefill":        # the plan's mirror of the layout
                assert smem_b == decompress_matmul.prefill_smem_bytes(
                    p.mrows, p.bn, pw.k), smem_b
            smem = f", {smem_b} B shared memory per CTA"
            tile = (f"bn {p.bn}, {p.splits} splits of {p.depth} rows"
                    if p.route == "decode" else f"{p.mrows} x {p.bn} tiles")
            log("kernels", f"decompress_matmul M={m} K={kk} N={n} k={pw.k}: "
                           f"{p.route} route, {tile}, {p.ctas(m, n)} CTAs"
                           f"{smem}; max "
                           f"|err| {float(err.max()):.3e} within "
                           f"1e-4*(|x|@|W|)+1e-6, two launches bit for bit; "
                           f"{t:.4f} ms, plain {t_plain:.4f} ms, torch.mm on "
                           f"the unpacked W {t_lib:.4f} ms, bound "
                           f"{max(t_bytes, t_ops):.5f} ms "
                           f"({'bytes' if t_bytes >= t_ops else 'ops'}); "
                           f"host {t_host:.1f} us per call")
            if m == 1024 and count > 1:      # a 1024-token prefill's share
                pre["ms"] += count * t
                pre["plain_ms"] += count * t_plain
                pre["library_ms"] += count * t_lib
                pre["bound_ms"] += count * max(t_bytes, t_ops)
            if m == 4:                       # one decode step's share
                dm["ms"] += count * t
                dm["plain_ms"] += count * t_plain
                dm["library_ms"] += count * t_lib
                dm["b_bytes"] += count * t_bytes
                dm["b_ops"] += count * t_ops
                dm["host_us"] += count * t_host
                dm["max_abs_err"] = max(dm["max_abs_err"], float(err.max()))
            del got, again, want, tol, err
        rows = (pw.signman.reshape(1, -1), pw.planes.reshape(1, pw.k, -1),
                pw.dict_syms.reshape(1, -1))
        fn = lambda: lexi_unpack.lexi_unpack(*rows, pw.k)
        assert torch.equal(i16(fn()), i16(w.reshape(1, -1)))
        t = cuda_ms(fn)
        t_plain = cuda_ms(lambda: ref.unpack_ref(*rows, pw.k), reps=3)
        t_host = host_us(fn)
        t_bound = (pw.nbytes() + 2 * kk * n) / HBM_BYTES_PER_S * 1e3
        log("kernels", f"lexi_unpack K={kk} N={n} k={pw.k}: exact; {t:.4f} "
                       f"ms, plain {t_plain:.4f} ms, bound {t_bound:.5f} ms; "
                       f"host {t_host:.1f} us per call")
        un["ms"] += count * t
        un["plain_ms"] += count * t_plain
        un["bound_ms"] += count * t_bound
        un["host_us"] += count * t_host
        packed.append((pw, count))
        del w, fields, rows
        torch.cuda.empty_cache()
    n_pre = sum(c for _, c in weight_shapes(cfg) if c > 1)
    log("kernels", f"decompress_matmul's prefill route, one 1024-token "
                   f"prefill's {n_pre} block matmuls (M=1024) summed: "
                   f"{pre['ms']:.3f} ms; plain {pre['plain_ms']:.3f} ms; "
                   f"torch.mm on the unpacked W "
                   f"{pre['library_ms']:.3f} ms; bound {pre['bound_ms']:.3f} "
                   f"ms ({pre['bound_ms'] / pre['ms']:.1%} of it reached)")
    m_sweep(packed)
    n_mm = sum(c for _, c in weight_shapes(cfg))
    rec = {
        "decompress_matmul": dict(
            max_abs_err=dm["max_abs_err"], ms=dm["ms"],
            plain_ms=dm["plain_ms"],
            bound_ms=max(dm["b_bytes"], dm["b_ops"]),
            bound_by="bytes" if dm["b_bytes"] >= dm["b_ops"]
            else "operations", library_ms=dm["library_ms"]),
        "lexi_unpack": dict(max_abs_err=0, ms=un["ms"],
                            plain_ms=un["plain_ms"], bound_ms=un["bound_ms"],
                            bound_by="bytes", library_ms=None)}
    for name in ("decompress_matmul", "lexi_unpack"):
        log("kernels", f"{name}, one decode step's {n_mm} weight matmuls "
                       f"at M=4, summed: {rec[name]}")
    return rec


SWEEP_M = (1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 256)


def m_sweep(packed):
    """decompress_matmul's two routes at each M of SWEEP_M, one decode
    step's weight matmuls summed (``packed``: [(PackedWeight, count)]):
    the largest M up to which the decode route is no slower is where the
    plan's threshold (DECODE_MAX_M) belongs; the route must win at every
    slot count (M <= 64)."""
    import torch
    from repro_torch.kernels import decompress_matmul

    gen = torch.Generator(device="cuda").manual_seed(7)
    sums = {}
    for m in SWEEP_M:
        sums[m] = {}
        for route in ("decode", "prefill"):
            total = 0.0
            for pw, count in packed:
                x = torch.randn((m, pw.shape[0]), generator=gen,
                                device="cuda").to(torch.bfloat16)
                total += count * cuda_ms(
                    lambda: decompress_matmul.decompress_matmul(
                        x, pw.signman, pw.planes, pw.dict_syms, pw.k,
                        route=route), reps=10)
            sums[m][route] = total
    wins = [m for m in SWEEP_M if sums[m]["decode"] <= sums[m]["prefill"]]
    crossover = max((m for m in wins if all(w in wins for w in SWEEP_M
                                            if w <= m)), default=0)
    log("kernels", "decompress_matmul M sweep, one decode step's matmuls "
                   "summed, ms (decode / prefill route): " + ", ".join(
                       f"M={m} {r['decode']:.3f}/{r['prefill']:.3f}"
                       for m, r in sums.items()))
    threshold = decompress_matmul.DECODE_MAX_M
    log("kernels", f"the decode route is no slower up to M={crossover} of "
                   f"the sweep; the plan's threshold DECODE_MAX_M="
                   f"{threshold} ({'within' if threshold <= crossover else 'ABOVE'}"
                   f" it)")
    assert crossover >= 64 and threshold >= 64, sums


# ---------------------------------------------------------------------------
# phase 4: a tiny model on the card against the same model on the CPU
# ---------------------------------------------------------------------------

def small_phase():
    from repro_torch.kernels import ops

    for packed in (False, True):
        ops.reset_launch_counts()
        worst = small_model_diff(packed)
        launched = ops.launch_counts()
        assert (launched["decompress_matmul"] > 0) == packed, launched
        log("small", f"tiny dense model, {'packed' if packed else 'raw'} "
                     f"weights, prefill + 10 teacher-forced steps: card vs "
                     f"CPU logits max |diff| {worst:.2e} (<= 1e-2); "
                     f"decompress_matmul launches "
                     f"{launched['decompress_matmul']}")


def small_model_diff(packed: bool) -> float:
    import numpy as np
    import torch
    from repro_torch.configs.base import ModelConfig, RunConfig
    from repro_torch.core import weights
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.models import lm, params as PM
    from repro_torch.serve import engine

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=512,
                      head_dim=16, qk_norm=True)
    run = RunConfig(codec=CodecConfig(cache_block=4))
    params = PM.init_params(lm.lm_table(cfg),
                            torch.Generator().manual_seed(3))
    if packed:                    # CPU: torch backend; on the card: cuda
        params = weights.pack_serving_params(params)
        assert isinstance(params["blocks"]["attn"]["wq"],
                          weights.PackedWeight)
    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(rng.integers(0, 512, (2, 9)), dtype=torch.int32)
    worst = 0.0
    states, toks = {}, {}
    for dev in ("cpu", "cuda"):
        p = PM.to_device(params, dev)
        st = engine.empty_paged_state(cfg, run, 2, 64, device=dev)
        logits, d = engine.prefill_sequences(cfg, run, p, prompt.to(dev))
        engine.insert_sequences(cfg, run, st, d, [0, 1])
        states[dev], toks[dev] = (st, p), [logits.float().cpu()]
    feed = engine.greedy_token(toks["cpu"][0])
    for _ in range(10):                     # crosses two page flushes
        for dev in ("cpu", "cuda"):
            st, p = states[dev]
            toks[dev].append(engine.paged_decode_step(
                cfg, run, p, st, feed.to(dev)).float().cpu())
        feed = engine.greedy_token(toks["cpu"][-1])
    for a, b in zip(toks["cpu"], toks["cuda"]):
        assert torch.isfinite(b).all()
        worst = max(worst, float((a - b).abs().max()))
    assert worst <= 1e-2, worst
    return worst


# ---------------------------------------------------------------------------
# phase 5: serve full-width qwen3-4b
# ---------------------------------------------------------------------------

class FlushCheck:
    """Holds the ring flushes of one layer during a serve run against what
    the model produced.  While installed, ``cache.append_token_paged``
    records every K/V row the decode and replay steps append to that
    layer's rings; when a ring fills, the page ``plan_append`` mapped for
    it must decompress bit for bit to the ring, whose rows appended in this
    run must be the recorded ones (the rest came from the prefill, which
    the serve phase checks on its own).  Costs one host sync per step, so
    the engine it watches steps eagerly (``cuda_graphs=False``)."""

    def __init__(self, layer: int, run):
        from repro_torch.models import cache as cache_mod
        self.layer, self.run, self.cache = layer, run, cache_mod
        self.rows = {}              # slot -> {ring index: appended row}
        self.checked = 0            # flushed pages held against the model
        self.rows_checked = 0       # of their rows, appended in this run

    def __enter__(self):
        self._append = self.cache.append_token_paged
        self._release = self.cache.release_pages
        self.cache.append_token_paged = self.append
        self.cache.release_pages = self.release
        return self

    def __exit__(self, *exc):
        self.cache.append_token_paged = self._append
        self.cache.release_pages = self._release

    def release(self, pkv, slots_mask):
        for slot in range(len(slots_mask)):
            if slots_mask[slot]:
                self.rows.pop(slot, None)
        self._release(pkv, slots_mask)

    def append(self, cfg, run, pkv, layer, new_vals, plan):
        self._append(cfg, run, pkv, layer, new_vals, plan)
        if layer != self.layer:
            return
        import torch
        from repro_torch.core import fixed
        blk = self.run.codec.cache_block
        for slot, (row, on) in enumerate(zip(plan.rows.tolist(),
                                             plan.active.tolist())):
            if on:
                self.rows.setdefault(slot, {})[row - slot * blk] = \
                    new_vals[slot].to(torch.bfloat16).view(torch.int16) \
                    .clone()
        for slot, pid in zip(plan.flush_slots.tolist(),
                             plan.flush_pages.tolist()):
            ring = pkv.ring[layer][slot].view(torch.int16)
            rows = self.rows.pop(slot)
            for r, row in rows.items():
                assert torch.equal(ring[r], row), (slot, r)
            ct = fixed.Compressed(
                *(f[layer][pid] for f in (pkv.signman, pkv.planes,
                                          pkv.dict_syms, pkv.esc_pos,
                                          pkv.esc_raw)),
                n_escapes=torch.zeros((), dtype=torch.int32),
                shape=(blk, ring.shape[-1]), k=self.run.codec.k)
            back = fixed.decompress(ct).view(torch.int16)
            assert torch.equal(back, ring), (slot, pid)
            self.checked += 1
            self.rows_checked += len(rows)


def serve_phase(cfg, smi):
    """Serve a mixed request stream on ``cfg`` at page block 256."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import fixed
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.models import cache as cache_mod, lm
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import Request, ServeEngine, format_stats

    blk = 256
    run = RunConfig(codec=CodecConfig(cache_block=blk, decode_backend="auto"))
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, run, n_slots=4, max_len=8 * blk, seed=0,
                      device="cuda", cuda_graphs=False)
    torch.cuda.synchronize()
    log("serve", f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
                 f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
                 f"{cfg.vocab_size}, block {blk}; random init in "
                 f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    reqs = serve_mix(cfg, rng)
    last = cfg.n_layers - 1
    ops.reset_launch_counts()
    with FlushCheck(last, run) as flush:
        results, st = eng.run(reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert st.graph_replays == 0 and st.eager_steps > 0
    served = dict(reqs=reqs, run=run, stats=st,
                  streams=[r.tokens for r in results],
                  pool=pool_snapshot(eng.state.kv))
    for req, res in zip(reqs, results):
        assert len(res.tokens) == req.max_new_tokens, (req.uid, res)
        assert all(0 <= t < cfg.vocab_size for t in res.tokens), res.tokens
    # the raw-weight path: attention and the page codec; the weight
    # plane's kernels run in the weights phase
    assert all(launches[name] > 0 for name in SERVE_KERNELS), launches
    assert launches["decompress_matmul"] == launches["lexi_unpack"] == 0
    assert flush.checked >= 3, flush.checked
    log("serve", format_stats(st).replace("\n", " | "))
    log("serve", f"{st.tokens_per_s:.2f} tok/s, {st.requests_per_s:.3f} "
                 f"req/s, wall {st.wall_s:.2f}s (one host sync per step "
                 f"for the flush check), peak cache "
                 f"{st.peak_cache_bytes} B stored / {st.peak_cache_raw_bytes}"
                 f" B raw ({st.cache_ratio:.3f}x), pool "
                 f"{engine.paged_state_nbytes(eng.state)} B, launches "
                 f"{launches} | {smi}")
    log("serve", f"{flush.checked} ring flushes of layer {last} in the run "
                 f"(replay and decode) decode back bit for bit to their "
                 f"rings; their {flush.rows_checked} rows appended in the "
                 f"run equal the model's K/V of those steps")

    # freshly prefilled pool pages decode back to the model's K/V: four
    # 4-page prompts admitted through the engine's own functions
    n_tok = 4 * blk
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, n_tok)),
                              dtype=torch.int32, device="cuda")
    raw = {}

    def keep(i, kv):
        if i in (0, last):
            raw[i] = engine.kv_payload(*kv)
        return None

    lm.lm_forward(cfg, run, eng.params, prompts, want_cache=True,
                  cache_fn=keep)
    logits, d = engine.prefill_sequences(cfg, run, eng.params, prompts)
    assert torch.isfinite(logits).all()
    engine.insert_sequences(cfg, run, eng.state, d, [0, 1, 2, 3])
    pkv = eng.state.kv
    for b in range(4):
        for layer in (0, last):
            for col in range(4):
                pid = int(pkv.page_table[b, col])
                ctp = fixed.Compressed(
                    *(f[layer][pid] for f in (pkv.signman, pkv.planes,
                                              pkv.dict_syms, pkv.esc_pos,
                                              pkv.esc_raw)),
                    n_escapes=torch.zeros((), dtype=torch.int32),
                    shape=(blk, cache_mod.kv_width(cfg)), k=run.codec.k)
                back = fixed.decompress(ctp).view(torch.int16)
                want = raw[layer][b, col * blk:(col + 1) * blk]
                assert torch.equal(back, want.view(torch.int16))
    log("serve", f"pages of 4 fresh {n_tok}-token prefills (layers 0 and "
                 f"{last}) decode back to the model's K/V bit for bit")
    tok = engine.greedy_token(logits)
    return launches, eng, tok, served


def serve_mix(cfg, rng):
    """The serve phase's six requests over 4 slots.  (prompt, budget):
    1100 -> 4 prefilled pages; 500 -> 1 page, its replay crosses 512
    (flush in replay); 250 and 760 -> decode crosses 256 / 768 (flush in
    decode); 6 requests over 4 slots -> eviction and page reuse."""
    import numpy as np
    from repro_torch.serve.scheduler import Request

    specs = [(1100, 24), (500, 16), (250, 16), (760, 16), (300, 8),
             (640, 12)]
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, (s,))
                    .astype(np.int32), max_new_tokens=b)
            for i, (s, b) in enumerate(specs)]


POOL_FIELDS = ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
               "raw_pages", "ring")


def pool_snapshot(pkv, clone: bool = True):
    """Every byte a serving run can write to a paged pool: the host page
    table and page use, and on the card every page of every layer (used
    or freed) and the rings -- copies, or (``clone=False``) the pool's
    own tensors."""
    return dict(page_table=pkv.page_table.copy(),
                page_used=pkv.page_used.copy(),
                **{f: getattr(pkv, f).clone() if clone else getattr(pkv, f)
                   for f in POOL_FIELDS if getattr(pkv, f) is not None})


def check_graph_run(cfg, st, launches):
    """A serving run with CUDA graphs: one capture, replays, every eager
    step a flushing one, and the paged kernel launched once per layer in
    every step (the capture's warm-up included)."""
    assert st.cuda_graphs and st.graph_captures == 1, st
    assert st.graph_replays > 0, st
    assert st.eager_steps == st.flush_steps, st
    passes = st.eager_steps + st.graph_replays + st.graph_captures
    assert launches["decode_attend_paged"] == cfg.n_layers * passes, \
        (launches, passes)
    return passes


# ---------------------------------------------------------------------------
# phase 6: CUDA graphs of the paged decode step
# ---------------------------------------------------------------------------

def graphs_phase(cfg, serve_eng, tok, served, smi):
    """The serve phase's mix again, from CUDA graphs: streams, page
    tables, page use, every page and the rings equal to the eager run's
    bit for bit; then eagerly without the flush check, for the mix's
    timing; then the 4 slots' decode profiled both ways, and one flushing
    step timed on its own.  Returns the graph run's launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import ServeEngine, format_stats

    run, reqs, eager = served["run"], served["reqs"], served["stats"]
    stats = {}
    for graphs in (True, False):
        eng = ServeEngine(cfg, run, n_slots=4, max_len=8 * 256,
                          params=serve_eng.params, device="cuda",
                          cuda_graphs=graphs)
        ops.reset_launch_counts()
        results, st = eng.run(reqs)
        torch.cuda.synchronize()
        stats[graphs] = st
        assert [r.tokens for r in results] == served["streams"], graphs
        if not graphs:
            continue
        launches = ops.launch_counts()
        assert all(launches[name] > 0 for name in SERVE_KERNELS), launches
        passes = check_graph_run(cfg, st, launches)
        assert st.eager_steps + st.graph_replays == eager.eager_steps
        n_bytes = same_pools(served["pool"],
                             pool_snapshot(eng.state.kv, clone=False))
        log("graphs", f"raw weights, the serve mix from CUDA graphs: the "
                      f"eager run's streams ({sum(map(len, served['streams']))}"
                      f" tokens), page table, page use and all {n_bytes} B of "
                      f"pages and rings bit for bit; {st.eager_steps} eager "
                      f"steps = {st.flush_steps} flushing steps, "
                      f"{st.graph_replays} replayed, 1 capture; "
                      f"decode_attend_paged {launches['decode_attend_paged']}"
                      f" launches = {cfg.n_layers} x {passes} passes "
                      f"(the warm-up's included); launches {launches}")
        del eng
    del served["pool"]
    torch.cuda.empty_cache()
    for graphs, st in sorted(stats.items()):
        log("graphs", f"serve mix, {'CUDA graphs' if graphs else 'eager'}: "
                      + format_stats(st).replace("\n", " | "))
        log("graphs", f"serve mix, {'CUDA graphs' if graphs else 'eager'}: "
                      f"{st.tokens_per_s:.2f} tok/s, TTFT mean "
                      f"{st.ttft_mean_s * 1e3:.1f} / p50 "
                      f"{st.ttft_p50_s * 1e3:.1f} / p95 "
                      f"{st.ttft_p95_s * 1e3:.1f} ms, inter-token "
                      f"{st.inter_token_mean_s * 1e3:.2f} ms, wall "
                      f"{st.wall_s:.2f}s, {st.eager_steps} eager + "
                      f"{st.graph_replays} replayed steps | {smi}")
    profile_decode(cfg, serve_eng, tok, "decode")
    flush_step_time(cfg, serve_eng, tok, smi)
    return launches


def flush_step_time(cfg, eng, tok, smi):
    """One flushing step of the 4 slots (all at one length, so all four
    rings fill together: 36 ``compress_many`` calls of 4 pages), eager, on
    its own; beside it a replayed step and an eager step without a flush.
    Each is timed from a synchronised card to a synchronised card."""
    import torch
    from repro_torch.serve import engine

    st, blk = eng.state, eng.run_cfg.codec.cache_block
    dec = engine.PagedDecoder(cfg, eng.run_cfg, st, graphs=True)
    eager = engine.PagedDecoder(cfg, eng.run_cfg, st, graphs=False)
    dec.tok.copy_(tok)
    dec.step(eng.params)                            # captures (or flushes)
    while not (st.active & (st.lengths % blk == blk - 1)).any():
        dec.step(eng.params)

    def timed(d):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.step(eng.params)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    n_flush = int((st.active & (st.lengths % blk == blk - 1)).sum())
    flush0 = dec.counts.flush
    t_flush = timed(dec)
    assert dec.counts.flush == flush0 + 1
    t_replay = [timed(dec) for _ in range(3)]
    eager.tok.copy_(dec.tok)
    t_eager = [timed(eager) for _ in range(3)]
    log("graphs", f"one flushing step ({n_flush} rings fill, at length "
                  f"{int(st.lengths.max()) - 1}), eager, synchronised on "
                  f"both sides: {t_flush:.2f} ms; a replayed step "
                  f"{', '.join(f'{t:.2f}' for t in t_replay)} ms; an eager "
                  f"step without a flush "
                  f"{', '.join(f'{t:.2f}' for t in t_eager)} ms | {smi}")


def same_pools(a, b) -> int:
    """Assert two pool snapshots byte-identical; returns the bytes held."""
    import numpy as np
    import torch
    assert a.keys() == b.keys(), (a.keys(), b.keys())
    assert np.array_equal(a["page_table"], b["page_table"])
    assert np.array_equal(a["page_used"], b["page_used"])
    n = 0
    for f in POOL_FIELDS:
        if f in a:
            assert torch.equal(a[f].view(torch.uint8), b[f].view(torch.uint8)), f
            n += a[f].numel() * a[f].element_size()
    return n


def profile_decode(cfg, eng, tok, name: str, steps: int = 8):
    """Where a decode step of the paged engine's 4 slots goes, eager and
    from the CUDA graph (``engine.PagedDecoder``, the scheduler's decode
    window): windows of ``steps`` decode steps from ``tok`` (see
    ``profile_window``); the slots' caches grow by ``steps`` tokens a
    window.  Returns {mode: metrics}."""
    from repro_torch.serve import engine

    out = {}
    for graphs in (False, True):
        dec = engine.PagedDecoder(cfg, eng.run_cfg, eng.state, graphs)
        out["graph" if graphs else "eager"] = profile_window(
            f"{name}_graph" if graphs else name,
            lambda: dec.decode(eng.params, tok, steps).cpu(), steps,
            dec.counts)
    compare_profiles(name, out)
    return out


def compare_profiles(name, prof):
    e, g = prof["eager"], prof["graph"]
    log("profile", f"{name}: eager -> CUDA graph: host {e['host_ms']:.3f} -> "
                   f"{g['host_ms']:.3f} ms/step "
                   f"({e['host_ms'] / g['host_ms']:.2f}x), device busy "
                   f"{e['busy_ms']:.3f} -> {g['busy_ms']:.3f} ms/step, "
                   f"{e['tok_s']:.1f} -> {g['tok_s']:.1f} tok/s, host launch "
                   f"calls {e['host_launches']:.0f} -> "
                   f"{g['host_launches']:.1f} per step, kernels "
                   f"{e['kernels']:.0f} -> {g['kernels']:.0f} per step")


def profile_window(name: str, window, steps: int, counts=None):
    """``window()`` (``steps`` decode steps of 4 sequences, ending in a
    host read) warm, then timed, then under torch.profiler: device
    busy share, the kernels per step, the host's launch calls per step
    (``cudaLaunchKernel``-like and ``cudaGraphLaunch`` runtime calls) and
    the top kernels summed by name; with a decoder's ``counts``, its
    eager and replayed steps in the timed window.  The full table goes to
    chiprun_out/profile_<name>.txt.  Returns the metrics."""
    import dataclasses
    import torch

    window()                                        # warm (and capture)
    c0 = dataclasses.replace(counts) if counts is not None else None
    t0 = time.perf_counter()
    window()                                        # ends in a host read
    wall = time.perf_counter() - t0
    split = "" if counts is None else (
        f"; {counts.eager - c0.eager} eager steps "
        f"({counts.flush - c0.flush} flushing), "
        f"{counts.replays - c0.replays} replayed")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        window()
    events = prof.key_averages()
    # device-side rows only (the kernels themselves), so ops that launch
    # them are not counted twice
    rows = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    launch_calls = sum(e.count for e in events
                       if e.device_type == torch.autograd.DeviceType.CPU
                       and ("LaunchKernel" in e.key
                            or "GraphLaunch" in e.key))
    dev_total = sum(e.self_device_time_total for e in rows) / 1e3   # ms
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{name}.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    attend = sum(e.self_device_time_total for e in rows
                 if "decode_attend" in e.key) / 1e3
    kernels = sum(e.count for e in rows) / steps
    log("profile", f"{name}: {steps} decode steps, 4 sequences: wall "
                   f"{wall * 1e3:.1f} ms"
                   f" ({wall * 1e3 / steps:.2f} ms/step, profiler off); "
                   f"device busy {dev_total:.1f} ms in the profiled run "
                   f"({100 * dev_total / (wall * 1e3):.0f}% of the "
                   f"unprofiled wall), {kernels:.0f} kernels and "
                   f"{launch_calls / steps:.1f} host launch calls per step"
                   f"{split}")
    log("profile", f"{name}: host {wall * 1e3 / steps:.3f} ms/step; device "
                   f"busy {dev_total / steps:.3f} ms/step; attention "
                   f"{attend / steps:.3f} ms/step = "
                   f"{100 * attend / max(dev_total, 1e-9):.1f}% of device "
                   f"time")
    for e in top:
        log("profile", f"  {e.key[:60]}: {e.self_device_time_total / 1e3:.2f}"
                       f" ms over {e.count} calls")
    return dict(host_ms=wall * 1e3 / steps, busy_ms=dev_total / steps,
                tok_s=4 * steps / wall, kernels=kernels,
                host_launches=launch_calls / steps)


# ---------------------------------------------------------------------------
# phase 7: the fixed-batch loop
# ---------------------------------------------------------------------------

def fixed_phase(cfg, params, smi):
    """prefill + decode_step on 4 x 1000-token prompts, 40 steps at block
    256 (flush at 1024), raw weights; returns decode_attend's launches in
    the timed run."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.models import cache as cache_mod
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import Request, ServeEngine

    b, s, n, blk, prof_steps = 4, 1000, 40, 256, 8
    run = RunConfig(codec=CodecConfig(cache_block=blk))
    max_len = s + n + 8 * prof_steps   # + 2 x three profile windows, A/B
    last = cfg.n_layers - 1
    rng = np.random.default_rng(7)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                              dtype=torch.int32, device="cuda")

    def check_flush(run_, st):
        """The block the ring just filled decodes to the ring bit for bit."""
        idx = st.length // blk - 1
        for layer in (0, last):
            kv = st.kv[layer]
            back = cache_mod.load_block(kv, idx, run_.codec)
            assert torch.equal(back.view(torch.int16),
                               kv.ring.view(torch.int16)), (layer, idx)
        return idx

    def serve(run_, check: bool, keep=None):
        t0 = time.perf_counter()
        logits, st = engine.prefill(cfg, run_, params, prompts, max_len)
        assert torch.isfinite(logits).all()
        tok = engine.greedy_token(logits)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, flushed, t_check = [tok], [], 0.0
        for _ in range(n):
            if keep is not None:              # the logits of toks[-1]
                keep.append(logits[:, -1].float())
            logits = engine.decode_step(cfg, run_, params, st, tok)
            tok = engine.greedy_token(logits)
            toks.append(tok)
            if check and st.length % blk == 0:
                c0 = time.perf_counter()
                flushed.append(check_flush(run_, st))
                t_check += time.perf_counter() - c0
        out = torch.cat(toks, 1).cpu()
        t2 = time.perf_counter()
        return out, st, t1 - t0, t2 - t1 - t_check, flushed

    kept = []                          # logits of each token of out0
    out0, _, _, _, flushed = serve(run, check=True, keep=kept)
    assert flushed == [s // blk], flushed
    # lossless: the raw store gives the same tokens (the kernel's shared
    # memory tile holds the same bits either way)
    raw = RunConfig(codec=dataclasses.replace(CodecConfig.off(),
                                              cache_block=blk))
    out_raw = serve(raw, check=True)[0]
    assert torch.equal(out_raw, out0), "codec off changed the tokens"
    ops.reset_launch_counts()
    out, st, t_prefill, t_decode, _ = serve(run, check=False)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert torch.equal(out, out0), "fixed-batch loop is not deterministic"
    assert out.shape == (b, n + 1) and int(out.min()) >= 0 \
        and int(out.max()) < cfg.vocab_size
    assert launches["decode_attend"] == cfg.n_layers * n, launches
    assert launches["decode_attend_paged"] == 0, launches
    assert launches["exp_histogram"] > 0 and launches["lexi_pack"] > 0
    log("fixed", f"{cfg.name}, {b} x ({s} prompt + {n} new), block {blk}: "
                 f"prefill {t_prefill * 1e3:.1f} ms, {n} decode steps "
                 f"{t_decode * 1e3:.1f} ms = {t_decode * 1e3 / n:.2f} ms/step"
                 f" ({b * n / t_decode:.2f} decode tok/s; "
                 f"{b * n / (t_prefill + t_decode):.2f} tok/s with the "
                 f"prefill, as the launcher counts), launches {launches} | "
                 f"{smi}")
    log("fixed", f"ring flush at {(flushed[0] + 1) * blk} tokens: block "
                 f"{flushed[0]} of layers 0 and {last} decodes bit for bit "
                 f"to its ring; codec off (raw blocks through the same "
                 f"kernel) gives the same {b * (n + 1)} tokens")
    tok = out[:, -1:].to("cuda")
    graph_launches = fixed_graphs(cfg, run, params, prompts, max_len, n, smi)

    prof = {}
    for graphs in (False, True):
        dec = engine.FixedDecoder(cfg, run, params, st, tok, graphs)

        def window():
            dec.tok.copy_(tok)
            for _ in range(prof_steps):
                dec.step()
            return dec.tok.cpu()

        prof["graph" if graphs else "eager"] = profile_window(
            "decode_fixed_graph" if graphs else "decode_fixed", window,
            prof_steps, dec.counts)
    compare_profiles("decode_fixed", prof)

    eng = ServeEngine(cfg, run, n_slots=b, max_len=max_len, params=params,
                      device="cuda")
    reqs = [Request(uid=i, prompt=prompts[i].cpu().numpy(),
                    max_new_tokens=n + 1) for i in range(b)]
    t0 = time.perf_counter()
    results, _ = eng.run(reqs)
    wall = time.perf_counter() - t0
    same = sum(int(a == c) for r, row in zip(results, out.tolist())
               for a, c in zip(r.tokens, row))
    first = [next((i for i, (a, c) in enumerate(zip(r.tokens, row))
                   if a != c), None) for r, row in zip(results, out.tolist())]
    trunk = 1 << (s.bit_length() - 1)       # the scheduler's bucket
    log("fixed", f"ServeEngine on the same prompts ({s} = {trunk}-token "
                 f"trunk + {s - trunk} replayed tokens, wall {wall:.1f} s): "
                 f"{same}/{b * (n + 1)} tokens equal to the fixed-batch "
                 f"loop's; first divergence per sequence {first}")
    # at each first divergence: the fixed loop's own logits against the
    # ServeEngine path's (its trunk prefilled, the prompt tails replayed,
    # the fixed loop's tokens fed, all 4 slots in step)
    last = max((i for i in first if i is not None), default=None)
    if last is not None and last < len(kept):
        served = teacher_forced(cfg, run, params, prompts, trunk,
                                out0[:, :last].to("cuda"), max_len)
        for seq_i, i in enumerate(first):
            if i is None:
                continue
            m_fixed, m_serve, gap = logit_margins(kept[i][seq_i],
                                                  served[i][seq_i])
            log("fixed", f"fixed loop vs ServeEngine, sequence {seq_i} "
                         f"position {i} (fixed token {int(out0[seq_i, i])},"
                         f" ServeEngine {results[seq_i].tokens[i]}, its "
                         f"path teacher-forced: "
                         f"{int(served[i][seq_i].argmax())}): top-2 margin "
                         f"fixed {m_fixed:.4g} / ServeEngine path "
                         f"{m_serve:.4g}, largest logit gap {gap:.4g}: "
                         f"{'near-tie' if min(m_fixed, m_serve) <= gap else 'MARGIN ABOVE THE GAP'}")
        del served
    del kept

    # host time per step, the two decode loops in turns on the same
    # sequences: the fixed state above and the same prompts in the pool
    _, d = engine.prefill_sequences(cfg, run, params, prompts)
    engine.insert_sequences(cfg, run, eng.state, d, list(range(b)))
    dec = engine.PagedDecoder(cfg, run, eng.state, graphs=True)
    dec.decode(params, tok, st.length - s)        # to the fixed length
    loops = {"fixed": lambda t: engine.decode_step(cfg, run, params, st, t),
             "paged": lambda t: engine.paged_decode_step(cfg, run, params,
                                                         eng.state, t)}
    times = {"fixed": [], "paged": []}
    for name in ("paged", "fixed", "fixed", "paged"):
        t, t0 = tok, time.perf_counter()
        for _ in range(prof_steps // 2):
            t = engine.greedy_token(loops[name](t))
        t.cpu()
        times[name].append((time.perf_counter() - t0) * 1e3
                           / (prof_steps // 2))
    log("fixed", f"host ms per decode step in turns (paged, fixed, fixed, "
                 f"paged) on the same 4 sequences at ~{st.length} tokens: "
                 f"fixed {times['fixed']}, paged {times['paged']}")
    del eng, dec
    torch.cuda.empty_cache()
    return graph_launches


def fixed_graphs(cfg, run, params, prompts, max_len, n, smi):
    """The fixed loop (``engine.FixedDecoder``, as ``generate`` runs it)
    eagerly and from a CUDA graph: the same tokens, and every layer's
    block store and ring byte-identical; the ring flush at 1024 the only
    eager step of the graph run.  Returns the graph run's launches of
    ``decode_attend``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import engine

    b, s = prompts.shape
    runs = {}
    for graphs in (False, True):
        logits, st = engine.prefill(cfg, run, params, prompts, max_len)
        dec = engine.FixedDecoder(cfg, run, params, st,
                                  engine.greedy_token(logits), graphs)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [dec.tok.clone()]
        for _ in range(n):
            dec.step()
            out.append(dec.tok.clone())
        toks = torch.cat(out, 1).cpu()
        wall = time.perf_counter() - t0
        runs[graphs] = (toks, st, dec.counts, ops.launch_counts(), wall)
    (t_e, st_e, c_e, _, w_e), (t_g, st_g, c_g, launches, w_g) = \
        runs[False], runs[True]
    assert torch.equal(t_e, t_g), "fixed loop: graph tokens != eager"
    assert int(st_g.length_dev) == st_g.length == st_e.length == s + n
    n_bytes = 0
    for kv_e, kv_g in zip(st_e.kv, st_g.kv):
        for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
                  "ring"):
            a, g = getattr(kv_e, f), getattr(kv_g, f)
            assert torch.equal(a.view(torch.uint8), g.view(torch.uint8)), f
            n_bytes += a.numel() * a.element_size()
    flushes = sum((s + t) % 256 == 255 for t in range(n))
    assert c_e.eager == n and c_g.eager == c_g.flush == flushes == 1, c_g
    assert c_g.replays == n - flushes and c_g.captures == 1
    passes = c_g.eager + c_g.replays + c_g.captures
    assert launches["decode_attend"] == cfg.n_layers * passes, launches
    log("graphs", f"fixed loop, {b} x ({s} prompt + {n} steps), from a CUDA "
                  f"graph: tokens and all {n_bytes} B of block stores and "
                  f"rings equal to the eager loop's; {c_g.eager} eager step "
                  f"(the ring flush), {c_g.replays} replayed, 1 capture; "
                  f"decode_attend "
                  f"{launches['decode_attend']} launches = {cfg.n_layers} x "
                  f"{passes}; {n} steps in {w_e * 1e3:.1f} ms eager, "
                  f"{w_g * 1e3:.1f} ms from the graph (the capture "
                  f"included) | {smi}")
    del runs
    return launches["decode_attend"]


def logit_margins(a, b):
    """(top-2 margin of a, top-2 margin of b, largest |a - b|) of two
    logit rows: a margin within the gap is a near-tie, a flip the two
    computations may both rightly give."""
    ta, tb = a.float().topk(2).values, b.float().topk(2).values
    return (float(ta[0] - ta[1]), float(tb[0] - tb[1]),
            float((a.float() - b.float()).abs().max()))


def teacher_forced(cfg, run, params, prompts, trunk, forced, max_len):
    """Teacher-force greedy streams through the continuous engine's path:
    ``prompts`` (B, S) prefilled to ``trunk`` tokens in one batch
    (``engine.prefill_sequences``), the rest of each prompt and then
    ``forced`` (B, T) fed one paged decode step at a time, all B slots in
    step, as ``ServeEngine`` runs them.  Returns [T + 1] logits (B, Vp):
    entry i is what predicts stream position i."""
    import torch
    from repro_torch.serve import engine
    b, s = prompts.shape
    st = engine.empty_paged_state(cfg, run, b, max_len, device="cuda")
    logits, d = engine.prefill_sequences(cfg, run, params, prompts[:, :trunk])
    engine.insert_sequences(cfg, run, st, d, list(range(b)))
    feed = torch.cat([prompts[:, trunk:], forced], 1)
    out = [logits[:, -1]] if trunk == s else []
    for j in range(feed.shape[1]):
        logits = engine.paged_decode_step(cfg, run, params, st,
                                          feed[:, j:j + 1])
        if j >= s - trunk - 1:
            out.append(logits[:, -1])
    return out


# ---------------------------------------------------------------------------
# phase 8: serve from the packed weight plane
# ---------------------------------------------------------------------------

def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _nest(path, leaf):
    return leaf if not path else {path[0]: _nest(path[1:], leaf)}


def weights_phase(cfg, serve_eng, tok, smi):
    """Pack the serve phase's weights (raw, on the card), serve the
    launcher's demo mix from raw weights and from the packed store on
    both backends, then profile the serve phase's 4 slots decoding from
    the packed store (``cuda`` backend)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import weights
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import decompress_matmul, ops
    from repro_torch.serve.scheduler import (ServeEngine, demo_serving_setup,
                                             format_stats)

    params = serve_eng.params
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    packed = weights.pack_serving_params(params, backend="cuda")
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    pack_launches = ops.launch_counts()
    stored, raw = weights.weight_plane_bytes(packed)

    def named(tree, path=()):
        if isinstance(tree, dict):
            for key, v in tree.items():
                yield from named(v, path + (key,))
        else:
            yield path, tree

    ks = {".".join(p): leaf.k for p, leaf in named(packed)
          if isinstance(leaf, weights.PackedWeight)}
    log("weights", f"packed on the card in {t_pack:.2f}s "
                   f"(exp_histogram {pack_launches['exp_histogram']}, "
                   f"lexi_pack {pack_launches['lexi_pack']} launches): k per "
                   f"packed leaf {ks}; weight_plane_bytes {stored} B stored / "
                   f"{raw} B raw ({stored / raw:.4f})")
    for path in (("blocks", "mlp", "w_gate"), ("lm_head",)):
        t0 = time.perf_counter()
        cpu = _at(weights.pack_serving_params(
            _nest(path, _at(params, path).cpu())), path)
        card = _at(packed, path)
        assert isinstance(cpu, weights.PackedWeight) and cpu.k == card.k
        for f in ("signman", "planes", "dict_syms"):
            assert torch.equal(getattr(cpu, f), getattr(card, f).cpu()), f
        log("weights", f"{'.'.join(path)} {card.shape}: packed on the card "
                       f"== packed on the CPU byte for byte, k={card.k} "
                       f"(CPU pack {time.perf_counter() - t0:.1f}s)")

    streams, counts, stats, routes, pools = {}, {}, {}, {}, {}
    # the three weight stores from CUDA graphs (the engine's default on
    # the card), then the cuda backend eagerly, which the graph run must
    # equal byte for byte
    for name in ("raw", "unpack", "cuda", "cuda_eager"):
        be = name.split("_")[0]
        run = RunConfig(codec=dataclasses.replace(
            CodecConfig(), weight_backend="auto" if be == "raw" else be))
        run, max_len, reqs = demo_serving_setup(run, cfg.vocab_size, 1024,
                                                16, 6)
        eng = ServeEngine(cfg, run, n_slots=4, max_len=max_len,
                          params=params if be == "raw" else packed,
                          compress_weights=be != "raw", device="cuda",
                          cuda_graphs=name != "cuda_eager")
        ops.reset_launch_counts()
        results, st = eng.run(reqs)
        torch.cuda.synchronize()
        counts[name], stats[name] = ops.launch_counts(), st
        routes[name] = dict(decompress_matmul.launches_by_route)
        for req, res in zip(reqs, results):
            assert len(res.tokens) == req.max_new_tokens, (name, req.uid)
        streams[name] = [res.tokens for res in results]
        if be == "cuda":
            pools[name] = pool_snapshot(eng.state.kv)
        log("weights", f"{name}: " + format_stats(st).replace("\n", " | "))
        log("weights", f"{name}: {st.tokens_per_s:.2f} tok/s, TTFT mean "
                       f"{st.ttft_mean_s * 1e3:.1f} / p50 "
                       f"{st.ttft_p50_s * 1e3:.1f} / p95 "
                       f"{st.ttft_p95_s * 1e3:.1f} ms ({len(results)} "
                       f"requests), {st.requests_per_s:.3f} req/s, wall "
                       f"{st.wall_s:.2f}s, {st.decode_steps} decode steps, "
                       f"{st.n_admit_dispatches} prefills, launches "
                       f"{counts[name]}, decompress_matmul by route "
                       f"{routes[name]} | {smi}")
        del eng
        torch.cuda.empty_cache()
    assert streams["unpack"] == streams["raw"], "unpack streams != raw"
    assert streams["cuda"] == streams["cuda_eager"], "cuda: graph != eager"
    n_bytes = same_pools(pools["cuda"], pools["cuda_eager"])
    del pools
    st = stats["cuda"]
    for name in ("raw", "unpack", "cuda"):
        check_graph_run(cfg, stats[name], counts[name])
    assert stats["cuda_eager"].graph_replays == 0
    log("graphs", f"packed weights (cuda backend), the demo mix from CUDA "
                  f"graphs: the eager run's streams, page table, page use "
                  f"and all {n_bytes} B of pages and rings bit for bit; "
                  f"{st.eager_steps} eager steps = {st.flush_steps} "
                  f"flushing, {st.graph_replays} replayed, 1 capture; "
                  f"{stats['cuda_eager'].tokens_per_s:.2f} -> "
                  f"{st.tokens_per_s:.2f} tok/s, TTFT mean "
                  f"{stats['cuda_eager'].ttft_mean_s * 1e3:.1f} -> "
                  f"{st.ttft_mean_s * 1e3:.1f} ms, inter-token "
                  f"{stats['cuda_eager'].inter_token_mean_s * 1e3:.2f} -> "
                  f"{st.inter_token_mean_s * 1e3:.2f} ms | {smi}")
    pairs = [(uid, i, a, b) for uid, (ra, rb) in
             enumerate(zip(streams["raw"], streams["cuda"]))
             for i, (a, b) in enumerate(zip(ra, rb))]
    same = sum(a == b for _, _, a, b in pairs)
    first = next(((uid, i) for uid, i, a, b in pairs if a != b), None)
    log("weights", f"cuda backend: {same}/{len(pairs)} tokens equal to the "
                   f"raw run ({same / len(pairs):.4f}); first divergence "
                   f"(request, position): {first}; unpack backend: "
                   f"identical to raw")
    # each first divergence (once per distinct prompt and prefix), the raw
    # run's tokens teacher-forced through both weight stores: the prompt
    # prefilled, the tokens before the divergence fed one decode step each
    seen = set()
    for uid, (ra, rb) in enumerate(zip(streams["raw"], streams["cuda"])):
        i = next((j for j, (a, b) in enumerate(zip(ra, rb)) if a != b), None)
        key = (reqs[uid].prompt.tobytes(), tuple(ra[:i or 0]))
        if i is None or key in seen:
            continue
        seen.add(key)
        prompt = torch.as_tensor(reqs[uid].prompt, dtype=torch.int32,
                                 device="cuda")[None]
        forced = torch.as_tensor([ra[:i]], dtype=torch.int32, device="cuda")
        side = [teacher_forced(cfg, run, w, prompt, prompt.shape[1], forced,
                               max_len)[i][0] for w in (params, packed)]
        m_raw, m_cuda, gap = logit_margins(*side)
        log("weights", f"raw vs cuda, request {uid} position {i} (raw token "
                       f"{ra[i]}, cuda {rb[i]}; teacher-forced argmax "
                       f"{int(side[0].argmax())} / {int(side[1].argmax())}):"
                       f" top-2 margin raw {m_raw:.4g} / cuda {m_cuda:.4g}, "
                       f"largest logit gap {gap:.4g}: "
                       f"{'near-tie' if min(m_raw, m_cuda) <= gap else 'MARGIN ABOVE THE GAP'}")
    n_mm = sum(c for _, c in weight_shapes(cfg))
    for name, kernel, idle in (("cuda", "decompress_matmul", "lexi_unpack"),
                               ("cuda_eager", "decompress_matmul",
                                "lexi_unpack"),
                               ("unpack", "lexi_unpack", "decompress_matmul")):
        st, c = stats[name], counts[name]
        assert st.n_replay_dispatches == 0         # the mix has no tails
        # every decode step (eager or replayed), the graph's warm-up and
        # every batched prefill
        steps = st.eager_steps + st.graph_replays + st.graph_captures
        assert steps == st.decode_steps + st.graph_captures, st
        passes = steps + st.n_admit_dispatches
        assert c[kernel] > 0 and c[idle] == 0, (name, c)
        assert c[kernel] == n_mm * passes, (name, c[kernel], passes)
        assert st.weight_ratio < 0.95, st.weight_ratio
    # the cuda backend's admissions go through the prefill route (every
    # block matmul of a batched prefill; the LM head, on the last
    # positions only, and the decode steps through the decode route)
    for name in ("cuda", "cuda_eager"):
        st, r = stats[name], routes[name]
        steps = st.decode_steps + st.graph_captures
        assert r["prefill"] == (n_mm - 1) * st.n_admit_dispatches, r
        assert r["decode"] == n_mm * steps + st.n_admit_dispatches, r
    assert counts["raw"]["decompress_matmul"] == 0
    assert counts["raw"]["lexi_unpack"] == 0
    log("weights", f"{n_mm} packed matmuls per forward pass (decode step or "
                   f"batched prefill) on both backends; weight ratio "
                   f"{stats['cuda'].weight_ratio:.4f}; cuda backend: "
                   f"{routes['cuda']['prefill']} prefill-route launches = "
                   f"{n_mm - 1} x {stats['cuda'].n_admit_dispatches} "
                   f"admissions")
    serve_eng.params = packed
    profile_decode(cfg, serve_eng, tok, "decode_packed")
    return {"decompress_matmul": counts["cuda"]["decompress_matmul"],
            "lexi_unpack": counts["unpack"]["lexi_unpack"]}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    smi = device_phase()
    build_phase()
    cfg = get_config("qwen3-4b")
    rec = kernels_phase(cfg)
    small_phase()
    _, serve_eng, tok, served = serve_phase(cfg, smi)
    # launches on the main path's runs from CUDA graphs (replays counted)
    launches = graphs_phase(cfg, serve_eng, tok, served, smi)
    launches["decode_attend"] = fixed_phase(cfg, serve_eng.params, smi)
    launches.update(weights_phase(cfg, serve_eng, tok, smi))
    kernels = []
    for name, r in rec.items():
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
