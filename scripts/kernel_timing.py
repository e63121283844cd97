#!/usr/bin/env python3
"""Time the port's kernels on one NVIDIA GPU, two ways, beside the PyTorch
call that computes the same function.

    python3 scripts/kernel_timing.py [--tree DIR] [--label NAME]
        [--kernels attend,weights,codec,decode] [--breakdown]

Imports ``repro_torch`` from DIR/src (default: this checkout), builds that
tree's kernel library, and times, with chip_smoke.py's ``cuda_ms`` and
``host_us``:

  attend   both decode-attention kernels at chip_smoke.py's timed shapes
           (qwen3-4b's heads, block 256, k 5; ``decode_attend_paged``: 4
           slots of 300, 700, 1100 and 2000 tokens over pages with escapes
           and overflow; ``decode_attend``: 4 sequences of 1100 tokens),
           each checked against its plain version within 1e-4, beside SDPA
           on the same K/V;
  weights  ``decompress_matmul`` at each of qwen3-4b's six weight shapes
           (K, N), packed from N(0, 0.02) at the smallest escape-free k, at
           M = 4 (the decode route), 256 and 1024 (the prefill route),
           checked against its plain version within 1e-4 * (|x| @ |W|) +
           1e-6, beside ``torch.mm`` on the unpacked W; ``lexi_unpack`` of
           each shape, checked bit for bit; one decode step's sums at M = 4
           (7 matmuls per layer and the LM head, as chip_smoke.py counts
           them) and one prefill's sums at M = 1024 and 256 (the 252 block
           matmuls; the LM head runs on the last positions only);
  codec    ``exp_histogram`` and ``lexi_pack`` at chip_smoke.py's four
           codec shapes (a ring flush's page, the 16-page table, the fixed
           store's 3 records, the largest stacked weight leaf; k 5), each
           checked bit for bit against its plain version (the leaf's
           first and last rows); one ``fixed.compress_many`` of 1 and of
           16 pages, whole and by part; and the whole-model pack of
           full-width qwen3-4b's random weights (``pack_serving_params``,
           ``cuda`` backend; host clock, median of 3 after one warm-up);
  decode   the decode loops at full-width qwen3-4b (random N(0, 0.02)
           weights from seed 0, block 256, codec on, raw weights): 4
           sequences prefilled with 1024 random tokens, then windows of 8
           greedy steps, each ending in a host read, by the host's clock
           from a synchronised card -- ``engine.paged_decode_step`` and
           ``engine.decode_step`` eagerly (every tree has them), and
           ``engine.PagedDecoder`` / ``engine.FixedDecoder`` replaying
           their CUDA graphs where the tree has them; one window warms up
           (and captures), the median of 3 more is the reading, with
           their min and max.  No window crosses a ring flush.

Each reading:

  ms          median CUDA-event time, L2 flushed, then a spin on the card
              so that the host is ahead when the first event is reached:
              the kernel alone;
  ms_no_spin  the same without the spin: where the host's time to launch
              (the wrapper's checks, ctypes) exceeds the L2 flush's, the
              events count it too;
  host_us     the host's time per call.

The PyTorch yardsticks are read with the spin (``library_ms``; SDPA also
both ways and by host time).  To compare two trees, run the script once
per tree in turns (A, B, B, A) in one call of the card: only the tree's
``repro_torch`` differs between runs, the inputs come from the same seed.
``--breakdown`` also times ``decode_attend_paged`` (with the spin) on
escape-free pages at the timed lengths, the same pages raw (no decode),
one span per slot (4 x 128 tokens) and 16 slots of 1056 tokens, each
beside SDPA.

Prints one JSON line and appends it to chiprun_out/kernel_timing.jsonl.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def check(got, want):
    import torch
    o_k, _, l_k = got
    o_p, _, l_p = want
    torch.testing.assert_close(o_k / l_k.clamp(min=1e-30)[..., None],
                               o_p / l_p.clamp(min=1e-30)[..., None],
                               rtol=1e-4, atol=1e-4)


def timings(cs, fn, lib_fn):
    return dict(ms=cs.cuda_ms(fn), ms_no_spin=cs.cuda_ms(fn, spin=False),
                host_us=cs.host_us(fn), library_ms=cs.cuda_ms(lib_fn),
                library_ms_no_spin=cs.cuda_ms(lib_fn, spin=False),
                library_host_us=cs.host_us(lib_fn))


def paged(cs, h, hkv, hd, blk, k, gen):
    """chip_smoke's timed decode_attend_paged case."""
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import decode_attend, ref

    w, n = 2 * hkv * hd, blk * 2 * hkv * hd
    lengths = [300, 700, 1100, 2000]
    n_pages = sum(L // blk for L in lengths) + 2
    pages = cs._pages(gen, n_pages, blk, w)
    ct = fixed.compress_many(pages, k=k, esc_capacity=max(n // 128, 8))
    q, ring, page_ids, lens = cs.paged_case(gen, h, hd, n_pages, blk, w,
                                            lengths)
    args = (q, ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
            None, ring, page_ids, lens, ref.WINDOW_NONE)
    g = h // hkv
    kw = dict(k=k, kv_idx=tuple(min(i // g, hkv - 1) for i in range(h)),
              scale=hd ** -0.5)
    fn = lambda: decode_attend.decode_attend_paged(*args, **kw)
    check(fn(), ref.paged_decode_attend_plain(*args, **kw))
    rows = torch.cat([pages[page_ids.long()].reshape(len(lengths), -1, w),
                      ring], 1)
    return timings(cs, fn, cs.sdpa_fn(q, rows))


def fixed_batch(cs, h, hkv, hd, blk, k, gen):
    """chip_smoke's timed decode_attend case."""
    from repro_torch.kernels import decode_attend, ref

    b, length = 4, 1100
    blocks, ct, ring, q = cs._fixed_case(gen, b, h, hkv, hd, blk, length,
                                         k)
    args = (q, ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
            None, ring, length, ref.WINDOW_NONE)
    g = h // hkv
    kw = dict(k=k, kv_idx=tuple(min(i // g, hkv - 1) for i in range(h)),
              scale=hd ** -0.5)
    fn = lambda: decode_attend.decode_attend(*args, **kw)
    check(fn(), ref.decode_attend_plain(*args, **kw))
    return timings(cs, fn, cs.sdpa_fn(q, cs.fixed_rows(blocks, ring,
                                                       length)))


def breakdown(cs, h, hkv, hd, blk, k, gen):
    """decode_attend_paged on variants, each beside SDPA (ms, with the
    spin)."""
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import decode_attend, ref

    w = 2 * hkv * hd
    g = h // hkv
    kw = dict(k=k, kv_idx=tuple(min(i // g, hkv - 1) for i in range(h)),
              scale=hd ** -0.5)
    pages = torch.randn((20, blk, w), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
    ct = fixed.compress_many(pages, k=k)
    assert int(ct.n_escapes.sum()) == 0
    codec = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
             None)
    out = []
    for name, lengths, pool in (
            ("escape-free, lengths 300/700/1100/2000", [300, 700, 1100, 2000],
             codec),
            ("the same raw (codec off)", [300, 700, 1100, 2000],
             (None,) * 5 + (pages,)),
            ("one span per slot, 4 x 128", [128] * 4, codec),
            ("16 x 1056", [1056] * 16, codec)):
        s_ = len(lengths)
        table = torch.randint(0, 20, (s_, 8), generator=gen, device="cuda",
                              dtype=torch.int32)
        q = torch.randn((s_, h, hd), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        ring = torch.randn((s_, blk, w), generator=gen, device="cuda"
                           ).to(torch.bfloat16)
        args = (q, *pool, ring, table,
                torch.tensor(lengths, dtype=torch.int32, device="cuda"),
                ref.WINDOW_NONE)
        fn = lambda: decode_attend.decode_attend_paged(*args, **kw)
        check(fn(), ref.paged_decode_attend_plain(*args, **kw))
        rows = torch.cat([pages[table.long()].reshape(s_, -1, w), ring], 1
                         )[:, :max(lengths)]
        out.append(dict(case=name, ms=cs.cuda_ms(fn),
                        library_ms=cs.cuda_ms(cs.sdpa_fn(q, rows))))
    return out


def weight_kernels(cs, cfg, gen):
    """decompress_matmul (M = 4 and 1024) and lexi_unpack at each of the
    model's weight shapes, and one decode step's sums at M = 4."""
    import torch
    from repro_torch.core import weights
    from repro_torch.kernels import decompress_matmul, lexi_unpack, ref

    bf16 = torch.bfloat16
    shapes, step = [], dict(ms=0.0, ms_no_spin=0.0, host_us=0.0,
                            library_ms=0.0, bound_ms=0.0, unpack_ms=0.0,
                            unpack_ms_no_spin=0.0, unpack_host_us=0.0,
                            unpack_bound_ms=0.0)
    prefill = {m: dict(ms=0.0, library_ms=0.0, bound_ms=0.0)
               for m in (256, 1024)}
    for (kk, n), count in cs.weight_shapes(cfg):
        w = (torch.randn((kk, n), generator=gen, device="cuda") * 0.02
             ).to(bf16)
        pw = weights.pack_serving_params({"w": w}, backend="cuda")["w"]
        fields = (pw.signman, pw.planes, pw.dict_syms)
        row = dict(K=kk, N=n, k=pw.k, matmuls_per_step=count)
        for m in (4, 256, 1024):
            x = torch.randn((m, kk), generator=gen, device="cuda").to(bf16)
            fn = lambda: decompress_matmul.decompress_matmul(x, *fields, pw.k)
            got = fn()
            tol = 1e-4 * (x.float().abs() @ w.float().abs()) + 1e-6
            assert bool(((got - ref.decompress_matmul_ref(x, *fields, pw.k)
                          ).abs() <= tol).all()), (kk, n, m)
            del got, tol
            t = dict(ms=cs.cuda_ms(fn), ms_no_spin=cs.cuda_ms(fn, spin=False),
                     host_us=cs.host_us(fn),
                     library_ms=cs.cuda_ms(lambda: torch.mm(
                         x, w, out_dtype=torch.float32)),
                     bound_ms=1e3 * max(
                         (m * kk * 2 + pw.nbytes() + m * n * 4)
                         / cs.HBM_BYTES_PER_S,
                         2 * m * n * kk / cs.BF16_FLOPS))
            row[f"M{m}"] = t
            if m in prefill and count > 1:
                for key in prefill[m]:
                    prefill[m][key] += count * t[key]
            if m == 4:
                for key in ("ms", "ms_no_spin", "host_us", "library_ms",
                            "bound_ms"):
                    step[key] += count * t[key]
        rows = (pw.signman.reshape(1, -1), pw.planes.reshape(1, pw.k, -1),
                pw.dict_syms.reshape(1, -1))
        fn = lambda: lexi_unpack.lexi_unpack(*rows, pw.k)
        assert torch.equal(fn().view(torch.int16),
                           w.reshape(1, -1).view(torch.int16))
        t = dict(ms=cs.cuda_ms(fn), ms_no_spin=cs.cuda_ms(fn, spin=False),
                 host_us=cs.host_us(fn),
                 bound_ms=(pw.nbytes() + 2 * kk * n) / cs.HBM_BYTES_PER_S
                 * 1e3)
        row["lexi_unpack"] = t
        for key in ("ms", "ms_no_spin", "host_us", "bound_ms"):
            step[f"unpack_{key}"] += count * t[key]
        shapes.append(row)
        del w, pw, fields, rows, x
        torch.cuda.empty_cache()
    return dict(shapes=shapes, step_m4=step,
                **{f"prefill_m{m}": v for m, v in prefill.items()})


def codec(cs, gen):
    """The codec kernels at chip_smoke's shapes, compress_many's parts,
    and the whole-model pack time."""
    import statistics
    import time
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import weights
    from repro_torch.models import lm, params as PM

    blk, w, k = 256, 2048, 5
    n = blk * w
    pages = cs._pages(gen, 16, blk, w).reshape(16, n)
    shapes = {}
    for name, x in cs.codec_inputs(gen, pages):
        if name == "leaf":          # the plain versions' rows 0 and -1
            cs.codec_check(name, x[[0, -1]].contiguous(), k)
        else:
            cs.codec_check(name, x, k)
        shapes[name] = cs.codec_timing(x, k)
        del x
    share = cs.compress_share(pages, k, max(n // 128, 8))
    del pages
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-4b")
    params = PM.init_params(lm.lm_table(cfg),
                            torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = weights.pack_serving_params(params, backend="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del packed
    del params
    torch.cuda.empty_cache()
    return dict(shapes=shapes, compress_many=share,
                pack_s=statistics.median(times[1:]), pack_s_all=times)


def decode():
    """Host ms per step of the paged and fixed decode loops, eager and
    from CUDA graphs (see the module's docstring)."""
    import statistics
    import time
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.models import lm, params as PM
    from repro_torch.serve import engine

    steps, windows = 8, 3
    cfg = get_config("qwen3-4b")
    blk, b, s = 256, 4, 4 * 256
    run = RunConfig(codec=CodecConfig(cache_block=blk))
    max_len = s + steps * (windows + 1) + 8
    assert max_len // blk == s // blk, "a window would flush a ring"
    params = PM.init_params(lm.lm_table(cfg),
                            torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)),
        dtype=torch.int32, device="cuda")

    def paged_state():
        st = engine.empty_paged_state(cfg, run, b, max_len, device="cuda")
        logits, d = engine.prefill_sequences(cfg, run, params, prompts)
        engine.insert_sequences(cfg, run, st, d, list(range(b)))
        return engine.greedy_token(logits), st

    tok, paged = paged_state()
    _, fixed_st = engine.prefill(cfg, run, params, prompts, max_len)

    def paged_eager():
        t = tok
        for _ in range(steps):
            t = engine.greedy_token(engine.paged_decode_step(
                cfg, run, params, paged, t))
        return t.cpu()

    def fixed_eager():
        t = tok
        for _ in range(steps):
            t = engine.greedy_token(engine.decode_step(cfg, run, params,
                                                       fixed_st, t))
        return t.cpu()

    loops = dict(paged=paged_eager, fixed=fixed_eager)
    if hasattr(engine, "PagedDecoder"):
        dec = engine.PagedDecoder(cfg, run, paged_state()[1], graphs=True)
        loops["paged_graph"] = lambda: dec.decode(params, tok, steps).cpu()
        _, fixed_g = engine.prefill(cfg, run, params, prompts, max_len)
        fdec = engine.FixedDecoder(cfg, run, params, fixed_g, tok, True)

        def fixed_graph():
            fdec.tok.copy_(tok)
            for _ in range(steps):
                fdec.step()
            return fdec.tok.cpu()

        loops["fixed_graph"] = fixed_graph
    rec = {}
    for name, window in loops.items():
        window()                                  # warm (and capture)
        times = []
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window()
            times.append((time.perf_counter() - t0) * 1e3 / steps)
        ms = statistics.median(times)
        rec[name] = dict(host_ms=ms, min=min(times), max=max(times),
                         tok_s=b * 1e3 / ms)
        print(f"[decode] {name} {ms:.3f} ms/step (min {min(times):.3f}, "
              f"max {max(times):.3f}), {b * 1e3 / ms:.1f} tok/s", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernels", default="attend,weights",
                    help="comma-separated: attend, weights, codec, decode")
    ap.add_argument("--breakdown", action="store_true")
    opts = ap.parse_args()
    tree = opts.tree.resolve()
    if not (tree / "src" / "repro_torch").is_dir():
        print(f"{tree}/src/repro_torch not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("kernel_timing.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ops

    ops.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    h, hkv, hd, blk, k = 32, 8, 128, 256, 5           # qwen3-4b, block 256
    gen = torch.Generator(device="cuda").manual_seed(0)
    kinds = set(opts.kernels.split(","))
    if not kinds <= {"attend", "weights", "codec", "decode"}:
        ap.error(f"unknown --kernels {opts.kernels!r}")
    rec = dict(label=opts.label or str(tree), card=card)
    if "attend" in kinds:
        rec["decode_attend_paged"] = paged(cs, h, hkv, hd, blk, k, gen)
        rec["decode_attend"] = fixed_batch(cs, h, hkv, hd, blk, k, gen)
    if opts.breakdown:
        rec["breakdown"] = breakdown(cs, h, hkv, hd, blk, k, gen)
    if "weights" in kinds:
        from repro_torch.configs import get_config
        rec["weights"] = weight_kernels(cs, get_config("qwen3-4b"), gen)
    if "codec" in kinds:
        rec["codec"] = codec(cs, gen)
    if "decode" in kinds:
        rec["decode"] = decode()
    line = json.dumps(rec)
    print(line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "kernel_timing.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
