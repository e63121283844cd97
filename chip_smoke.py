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
               and the pack, rtol = atol = 1e-4 for paged attention.  Times
               each (CUDA events, median, L2 flushed between launches).
  4. small   — a tiny dense model decoded on the card and on the CPU from
               the same weights and tokens: logits agree within 1e-2.
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
  7. the card's line, the ``kernels`` JSON line, then the result line.
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
    return rec


# ---------------------------------------------------------------------------
# phase 4: a tiny model on the card against the same model on the CPU
# ---------------------------------------------------------------------------

def small_phase():
    import numpy as np
    import torch
    from repro_torch.configs.base import ModelConfig, RunConfig
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.models import lm, params as PM
    from repro_torch.serve import engine

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=512,
                      head_dim=16, qk_norm=True)
    run = RunConfig(codec=CodecConfig(cache_block=4))
    params = PM.init_params(lm.lm_table(cfg),
                            torch.Generator().manual_seed(3))
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
    log("small", f"tiny dense model, prefill + 10 teacher-forced steps: "
                 f"card vs CPU logits max |diff| {worst:.2e} (<= 1e-2)")


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
    assert all(v > 0 for v in launches.values()), launches
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
    profile_decode(cfg, run, eng, engine.greedy_token(logits))
    return launches, st


def profile_decode(cfg, run, eng, tok, steps: int = 8):
    """Where a decode step's device time goes: ``steps`` decode steps of
    4 slots under torch.profiler, kernels summed by name.  The full table
    goes to chiprun_out/profile_decode.txt."""
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
    (out / "profile_decode.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    log("profile", f"{steps} decode steps, 4 slots: wall {wall * 1e3:.1f} ms"
                   f" ({wall * 1e3 / steps:.2f} ms/step, profiler off); "
                   f"device busy {dev_total:.1f} ms in the profiled run "
                   f"({100 * dev_total / (wall * 1e3):.0f}% of the "
                   f"unprofiled wall), "
                   f"{sum(e.count for e in rows) / steps:.0f} kernel "
                   f"launches per step")
    for e in top:
        log("profile", f"  {e.key[:60]}: {e.self_device_time_total / 1e3:.2f}"
                       f" ms over {e.count} calls")


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
    launches, _ = serve_phase(cfg, smi)
    sources = {"decode_attend_paged": "src/repro/kernels/decode_attend.py:421",
               "exp_histogram": "src/repro/kernels/exp_histogram.py:47",
               "lexi_pack": "src/repro/kernels/lexi_pack.py:56"}
    kernels = []
    for name, r in rec.items():
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{name}.cu",
            replaces=sources[name], launches=launches[name],
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
