#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits
non-zero:

  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build   — compile the CUDA kernels from ``src/repro_torch/csrc`` into
               one library (one nvcc per source, in parallel, then a link).
  3. kernels — each kernel against its plain PyTorch version at the main
               path's shapes (qwen3-4b pages: block 256, W 2048, k 5;
               4 slots of 300..2000 tokens), including pages with escapes
               and with escape overflow; exact equality for the histogram
               and the pack, rtol = atol = 1e-4 for paged attention.
               The weight plane's kernels at qwen3-4b's weight shapes:
               ``lexi_unpack`` exact on one packed stacked leaf (36, 2560 x
               9728) and on the pool pages (``ops.unpack`` equal to
               ``fixed.decompress`` with escapes and overflow);
               ``decompress_matmul`` at the six (K, N) weight shapes with
               M = 4 (decode) and 1024 (prefill), elementwise within
               1e-4 * (|x| @ |W|) + 1e-6.  Times each (CUDA events, median,
               L2 flushed between launches); the two weight kernels' JSON
               rows are one decode step's 253 weight matmuls (7 per layer
               and the LM head) at M = 4, summed.
  4. small   — a tiny dense model decoded on the card and on the CPU from
               the same weights and tokens, raw and packed weights: logits
               agree within 1e-2.
  5. serve   — ServeEngine on full-width qwen3-4b (random weights from a
               seed): 6 mixed requests over 4 slots, pages filled at
               prefill and by ring flushes in replay and decode.  Every
               request must get its budget and every kernel must have
               launched.  In the last layer, every page a ring flush wrote
               during the run must decode back, bit for bit, to its ring,
               whose rows appended in the run must be the K/V the decode
               and replay steps produced; so must the pages of four fresh
               prefills, against the K/V of the model's forward pass.
  6. profile — 8 decode steps of those 4 slots under torch.profiler:
               device busy share and the top kernels (full table in
               ``chiprun_out/profile_decode.txt``).
  7. weights — the serve phase's full-width weights packed on the card
               (time, each packed leaf's k, ``weight_plane_bytes``); the
               packed fields of ``blocks.mlp.w_gate`` and ``lm_head``
               byte-identical to the same leaves packed on the CPU; then
               the launcher's tail-free demo mix (6 requests over 4 slots,
               prompts 1024/512, budgets 32/16) served three ways: raw
               weights, ``weight_backend="unpack"`` (streams must equal the
               raw ones) and ``"cuda"`` (its share of tokens equal to the
               raw run and its first divergence are printed).  Every
               request gets its budget; both weight kernels launch.
               Last, the serve phase's 4 slots decode 8 steps from the
               packed store under the profiler, as in phase 6
               (``chiprun_out/profile_decode_packed.txt``).
  8. the card's line, the ``kernels`` JSON line, then the result line.
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
            "lexi_unpack": "src/repro/kernels/lexi_unpack.py:51"}
SERVE_KERNELS = ("decode_attend_paged", "exp_histogram", "lexi_pack")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms; the 50 MB L2 is flushed before
    every timed launch (the decode path meets its pages cold)."""
    import torch
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


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
    for name in ops.KERNELS:
        for line in (ops.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")
    ops.library()


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


def kernels_phase(cfg):
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import decode_attend, exp_histogram, lexi_pack
    from repro_torch.kernels import ops, ref
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

    # exp_histogram: exact, integer
    want = ref.histogram_ref(rows)
    got = ops.histogram(rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "exp_histogram != plain"
    g = n_pages
    rec["exp_histogram"] = dict(
        max_abs_err=int((got - want).abs().max()),
        ms=cuda_ms(lambda: exp_histogram.exp_histogram(rows)),
        plain_ms=cuda_ms(lambda: ref.histogram_ref(rows), reps=5),
        bound_ms=2 * n * g / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    log("kernels", f"exp_histogram ({g} x {n}) exact: "
                   f"{rec['exp_histogram']}")

    # lexi_pack: exact bytes, with each page's own dictionary
    _, enc_lut = fixed.build_dictionary(want, k)
    sm_k, pl_k = ops.pack(rows, enc_lut, k)
    sm_p, pl_p = ref.pack_ref(rows, enc_lut, k)
    torch.cuda.synchronize()
    assert torch.equal(sm_k, sm_p) and torch.equal(pl_k, pl_p), \
        "lexi_pack != plain"
    rec["lexi_pack"] = dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: lexi_pack.lexi_pack(rows, enc_lut, k)),
        plain_ms=cuda_ms(lambda: ref.pack_ref(rows, enc_lut, k), reps=5),
        bound_ms=(2 * n + n + k * n / 8) * g / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None)
    log("kernels", f"lexi_pack ({g} x {n}, k={k}) exact: "
                   f"{rec['lexi_pack']}")

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
    page_ids = table.clamp(min=0).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = (torch.randn((s_, h, hd), generator=gen, device="cuda")
         ).to(torch.bfloat16)
    ring = torch.randn((s_, blk, w), generator=gen, device="cuda") \
        .to(torch.bfloat16)
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
    # yardstick: one library call (SDPA, GQA) on already-decompressed
    # pages gathered per slot; the port never calls it
    kv_t = torch.cat([raw[-1][page_ids.long()].reshape(s_, -1, w), ring],
                     1).reshape(s_, -1, hkv, 2, hd)
    kk, vv = kv_t[..., 0, :].transpose(1, 2), kv_t[..., 1, :].transpose(1, 2)
    lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kk, vv, enable_gqa=True)
    ring_rows = sum(L % blk for L in lengths)
    page_bytes = n * (1 + k / 8) + c
    by = (n_live * page_bytes + ring_rows * w * 2 + q.numel() * 2
          + s_ * h * (hd + 2) * 4)
    flops = 4 * s_ * h * hd * sum(lengths)
    t_bytes, t_ops = by / HBM_BYTES_PER_S, flops / F32_FLOPS
    rec["decode_attend_paged"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: decode_attend.decode_attend_paged(
            *args, k=k, kv_idx=kv_idx, scale=scale)),
        plain_ms=cuda_ms(lambda: ref.paged_decode_attend_plain(
            *args, k=k, kv_idx=kv_idx, scale=scale), reps=5),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=cuda_ms(lib_fn))
    log("kernels", f"decode_attend_paged (S={s_}, H={h}/{hkv}, hd={hd}, "
                   f"lengths {lengths}, {n_live} live pages) within 1e-4 "
                   f"(full + window 700 + codec off): "
                   f"{rec['decode_attend_paged']}")
    rec.update(weight_kernels(cfg, ct, gen))
    return rec


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
              b_ops=0.0, max_abs_err=0.0)
    un = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for (kk, n), count in weight_shapes(cfg):
        w = (torch.randn((kk, n), generator=gen, device="cuda") * 0.02
             ).to(bf16)
        pw = weights.pack_serving_params({"w": w}, backend="cuda")["w"]
        fields = (pw.signman, pw.planes, pw.dict_syms)
        for m in (4, 1024):
            x = torch.randn((m, kk), generator=gen, device="cuda").to(bf16)
            got = decompress_matmul.decompress_matmul(x, *fields, pw.k)
            want = ref.decompress_matmul_ref(x, *fields, pw.k)
            tol = 1e-4 * (x.float().abs() @ w.float().abs()) + 1e-6
            err = (got - want).abs()
            assert bool((err <= tol).all()), (kk, n, m, float(err.max()))
            t = cuda_ms(lambda: decompress_matmul.decompress_matmul(
                x, *fields, pw.k))
            t_plain = cuda_ms(lambda: ref.decompress_matmul_ref(
                x, *fields, pw.k), reps=3)
            t_lib = cuda_ms(lambda: torch.mm(x, w, out_dtype=torch.float32))
            t_bytes = (m * kk * 2 + pw.nbytes() + m * n * 4) \
                / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * m * n * kk / BF16_FLOPS * 1e3
            log("kernels", f"decompress_matmul M={m} K={kk} N={n} k={pw.k}: "
                           f"max |err| {float(err.max()):.3e} within "
                           f"1e-4*(|x|@|W|)+1e-6; {t:.4f} ms, plain "
                           f"{t_plain:.4f} ms, torch.mm on the unpacked W "
                           f"{t_lib:.4f} ms, bound {max(t_bytes, t_ops):.5f}"
                           f" ms ({'bytes' if t_bytes >= t_ops else 'ops'})")
            if m == 4:                       # one decode step's share
                dm["ms"] += count * t
                dm["plain_ms"] += count * t_plain
                dm["library_ms"] += count * t_lib
                dm["b_bytes"] += count * t_bytes
                dm["b_ops"] += count * t_ops
                dm["max_abs_err"] = max(dm["max_abs_err"], float(err.max()))
            del got, want, tol, err
        rows = (pw.signman.reshape(1, -1), pw.planes.reshape(1, pw.k, -1),
                pw.dict_syms.reshape(1, -1))
        assert torch.equal(i16(lexi_unpack.lexi_unpack(*rows, pw.k)),
                           i16(w.reshape(1, -1)))
        t = cuda_ms(lambda: lexi_unpack.lexi_unpack(*rows, pw.k))
        t_plain = cuda_ms(lambda: ref.unpack_ref(*rows, pw.k), reps=3)
        t_bound = (pw.nbytes() + 2 * kk * n) / HBM_BYTES_PER_S * 1e3
        log("kernels", f"lexi_unpack K={kk} N={n} k={pw.k}: exact; {t:.4f} "
                       f"ms, plain {t_plain:.4f} ms, bound {t_bound:.5f} ms")
        un["ms"] += count * t
        un["plain_ms"] += count * t_plain
        un["bound_ms"] += count * t_bound
        del w, pw, fields, rows
        torch.cuda.empty_cache()
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
        logits, d = engine.prefill(cfg, run, p, prompt.to(dev))
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
    the serve phase checks on its own).  Costs one host sync per step."""

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
        for slot, r in zip(plan.write_slots.tolist(), plan.ring_idx.tolist()):
            self.rows.setdefault(slot, {})[r] = \
                new_vals[slot].to(torch.bfloat16).view(torch.int16).clone()
        blk = self.run.codec.cache_block
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
                      device="cuda")
    torch.cuda.synchronize()
    log("serve", f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
                 f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
                 f"{cfg.vocab_size}, block {blk}; random init in "
                 f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    # (prompt, budget): 1100 -> 4 prefilled pages; 500 -> 1 page, its
    # replay crosses 512 (flush in replay); 250 and 760 -> decode crosses
    # 256 / 768 (flush in decode); 6 requests over 4 slots -> eviction and
    # page reuse
    specs = [(1100, 24), (500, 16), (250, 16), (760, 16), (300, 8),
             (640, 12)]
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, (s,))
                    .astype(np.int32), max_new_tokens=b)
            for i, (s, b) in enumerate(specs)]
    last = cfg.n_layers - 1
    ops.reset_launch_counts()
    with FlushCheck(last, run) as flush:
        results, st = eng.run(reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
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
    logits, d = engine.prefill(cfg, run, eng.params, prompts)
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
    profile_decode(cfg, run, eng, tok, "decode")
    return launches, eng, tok


def profile_decode(cfg, run, eng, tok, name: str, steps: int = 8):
    """Where a decode step's device time goes: ``steps`` decode steps of
    4 slots under torch.profiler, kernels summed by name.  The full table
    goes to chiprun_out/profile_<name>.txt.  Each window starts from
    ``tok``; the slots' caches grow by ``steps`` tokens a window."""
    import torch
    from repro_torch.serve import engine

    def window():
        t = tok
        for _ in range(steps):
            t = engine.greedy_token(engine.paged_decode_step(
                cfg, run, eng.params, eng.state, t))
        return t.cpu()

    window()                                        # warm
    t0 = time.perf_counter()
    window()                                        # ends in a host read
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        window()
    # device-side rows only (the kernels themselves), so ops that launch
    # them are not counted twice
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_total = sum(e.self_device_time_total for e in rows) / 1e3   # ms
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{name}.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    log("profile", f"{name}: {steps} decode steps, 4 slots: wall "
                   f"{wall * 1e3:.1f} ms"
                   f" ({wall * 1e3 / steps:.2f} ms/step, profiler off); "
                   f"device busy {dev_total:.1f} ms in the profiled run "
                   f"({100 * dev_total / (wall * 1e3):.0f}% of the "
                   f"unprofiled wall), "
                   f"{sum(e.count for e in rows) / steps:.0f} kernel "
                   f"launches per step")
    for e in top:
        log("profile", f"  {e.key[:60]}: {e.self_device_time_total / 1e3:.2f}"
                       f" ms over {e.count} calls")


# ---------------------------------------------------------------------------
# phase 7: serve from the packed weight plane
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
    from repro_torch.kernels import ops
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

    streams, counts, stats = {}, {}, {}
    for name in ("raw", "unpack", "cuda"):
        run = RunConfig(codec=dataclasses.replace(
            CodecConfig(), weight_backend="auto" if name == "raw" else name))
        run, max_len, reqs = demo_serving_setup(run, cfg.vocab_size, 1024,
                                                16, 6)
        eng = ServeEngine(cfg, run, n_slots=4, max_len=max_len,
                          params=params if name == "raw" else packed,
                          compress_weights=name != "raw", device="cuda")
        ops.reset_launch_counts()
        results, st = eng.run(reqs)
        torch.cuda.synchronize()
        counts[name], stats[name] = ops.launch_counts(), st
        for req, res in zip(reqs, results):
            assert len(res.tokens) == req.max_new_tokens, (name, req.uid)
        streams[name] = [res.tokens for res in results]
        log("weights", f"{name}: " + format_stats(st).replace("\n", " | "))
        log("weights", f"{name}: {st.tokens_per_s:.2f} tok/s, "
                       f"{st.requests_per_s:.3f} req/s, wall {st.wall_s:.2f}s,"
                       f" {st.decode_steps} decode steps, "
                       f"{st.n_admit_dispatches} prefills, launches "
                       f"{counts[name]} | {smi}")
        del eng
        torch.cuda.empty_cache()
    assert streams["unpack"] == streams["raw"], "unpack streams != raw"
    pairs = [(uid, i, a, b) for uid, (ra, rb) in
             enumerate(zip(streams["raw"], streams["cuda"]))
             for i, (a, b) in enumerate(zip(ra, rb))]
    same = sum(a == b for _, _, a, b in pairs)
    first = next(((uid, i) for uid, i, a, b in pairs if a != b), None)
    log("weights", f"cuda backend: {same}/{len(pairs)} tokens equal to the "
                   f"raw run ({same / len(pairs):.4f}); first divergence "
                   f"(request, position): {first}; unpack backend: "
                   f"identical to raw")
    n_mm = sum(c for _, c in weight_shapes(cfg))
    for name, kernel, idle in (("cuda", "decompress_matmul", "lexi_unpack"),
                               ("unpack", "lexi_unpack", "decompress_matmul")):
        st, c = stats[name], counts[name]
        assert st.n_replay_dispatches == 0         # the mix has no tails
        passes = st.decode_steps + st.n_admit_dispatches
        assert c[kernel] > 0 and c[idle] == 0, (name, c)
        assert c[kernel] == n_mm * passes, (name, c[kernel], passes)
        assert st.weight_ratio < 0.95, st.weight_ratio
    assert counts["raw"]["decompress_matmul"] == 0
    assert counts["raw"]["lexi_unpack"] == 0
    log("weights", f"{n_mm} packed matmuls per forward pass (decode step or "
                   f"batched prefill) on both backends; weight ratio "
                   f"{stats['cuda'].weight_ratio:.4f}")
    serve_eng.params = packed
    profile_decode(cfg, serve_eng.run_cfg, serve_eng, tok, "decode_packed")
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
    launches, serve_eng, tok = serve_phase(cfg, smi)
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
