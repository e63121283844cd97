"""Serving demo on one GPU (ports ``repro/launch/serve.py``): fixed batch
(prefill a prompt batch, decode greedily; the default) or continuous
batching (a request stream through ``ServeEngine``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --batch 4 --prompt-len 64 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --no-reduced --continuous --requests 6 --slots 4 --prompt-len 1024 \
        --new-tokens 16 [--compress-weights [--weight-backend unpack]]

Weights are a seeded random init (no checkpoint ships with the repo).
``--reduced`` (the default) serves ``make_reduced(cfg)``; ``--no-reduced``
serves the published width.  ``--device cpu`` runs the kernels' plain
versions on the CPU.  Fixed-batch mode with ``--codec full`` uses
32-token cache blocks, as the reference does, so the default 64 + 32-token
run decodes from full compressed blocks.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import get_config, make_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.core.collectives import CodecConfig
from repro_torch.kernels.ops import DECODE_BACKENDS, WEIGHT_BACKENDS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed-batch mode: sequences decoded in lockstep")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--codec", default="full", choices=["full", "off"])
    ap.add_argument("--continuous", action="store_true",
                    help="serve a request stream through the "
                         "continuous-batching engine")
    ap.add_argument("--requests", type=int, default=8,
                    help="continuous mode: number of queued requests")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous mode: decode slots")
    ap.add_argument("--decode-backend", default="auto",
                    choices=list(DECODE_BACKENDS),
                    help="decode attention: auto (by device), cuda (the "
                         "kernel; needs --device cuda) or torch (the plain "
                         "version; needs --device cpu)")
    ap.add_argument("--compress-weights", action="store_true",
                    help="continuous mode: serve from the LEXI-packed "
                         "weight store (weights decompressed just in time "
                         "at every matmul)")
    ap.add_argument("--weight-backend", default="auto",
                    choices=list(WEIGHT_BACKENDS),
                    help="packed-weight matmuls: auto (by device), cuda "
                         "(the fused decompress_matmul kernel), unpack (the "
                         "lexi_unpack kernel, then the raw product; both "
                         "need --device cuda) or torch (the plain version; "
                         "needs --device cpu)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="continuous mode: evict a slot when it emits this "
                         "token id")
    ap.add_argument("--stop-seq", type=str, default=None,
                    help="continuous mode: comma-separated token ids; a "
                         "slot stops when its stream ends with them "
                         "(stop_reason=stop_string)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    codec = (CodecConfig() if args.codec == "full" else CodecConfig.off())
    run = RunConfig(codec=dataclasses.replace(
        codec, decode_backend=args.decode_backend,
        weight_backend=args.weight_backend))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    if args.continuous:
        return _serve_continuous(cfg, run, args)
    if args.compress_weights:
        ap.error("--compress-weights needs --continuous")
    return _serve_fixed(cfg, run, args)


def _serve_fixed(cfg, run: RunConfig, args) -> int:
    """Prefill ``--batch`` prompts and decode them greedily in lockstep,
    once to warm up (kernel build, allocator) and once timed."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm, params as PM
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import resolve_device

    if run.codec.cache:
        run = dataclasses.replace(run, codec=dataclasses.replace(
            run.codec, cache_block=32))
    device = resolve_device(args.device)
    ops.resolve_decode_backend(run.codec, device)
    if device.type == "cuda":
        # f32 products (prefill attention) stay f32, as in the reference
        torch.backends.cuda.matmul.allow_tf32 = False
    b, s, n = args.batch, args.prompt_len, args.new_tokens
    max_len = s + n + run.codec.cache_block
    params = PM.init_params(
        lm.lm_table(cfg), torch.Generator(device=device).manual_seed(run.seed),
        device=device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                              dtype=torch.int32, device=device)

    def serve():
        return engine.generate(cfg, run, params, prompts, n, max_len).cpu()

    t0 = time.perf_counter()
    serve()
    dt = time.perf_counter() - t0
    print(f"[serve] {b} seqs x ({s} prompt + {n} new) in {dt:.1f}s "
          f"({b * n / dt:.1f} tok/s incl. warm-up)")
    t0 = time.perf_counter()
    out = serve()
    dt = time.perf_counter() - t0
    print(f"[serve] steady-state: {b * n / dt:.1f} tok/s")
    n_tok = b * (n + 1)
    codec = "on" if run.codec.cache else "off"
    print(f"[serve] stats: {b} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s), decode backend "
          f"{ops.resolve_decode_backend(run.codec, device)}, codec {codec}, "
          f"cache block {run.codec.cache_block}")
    print("[serve] sample continuations:", out[:2, :12].tolist())
    return 0


def _serve_continuous(cfg, run: RunConfig, args) -> int:
    from repro_torch.serve.scheduler import (ServeEngine, demo_serving_setup,
                                             format_stats)
    run, max_len, reqs = demo_serving_setup(
        run, cfg.vocab_size, args.prompt_len, args.new_tokens, args.requests)
    stops = ([tuple(int(t) for t in args.stop_seq.split(","))]
             if args.stop_seq else None)
    eng = ServeEngine(cfg, run, n_slots=args.slots, max_len=max_len,
                      seed=run.seed, eos_id=args.eos_id, stop_seqs=stops,
                      compress_weights=args.compress_weights,
                      device=args.device)
    results, st = eng.run(reqs)
    print("[serve] continuous:", format_stats(st))
    print("[serve] sample continuations:",
          [(r.tokens[:6], r.stop_reason) for r in results[:2]])
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
