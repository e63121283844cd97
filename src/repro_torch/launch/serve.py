"""Serving demo (ports ``repro/launch/serve.py``): fixed batch (prefill a
prompt batch, decode greedily; the default) or continuous batching (a
request stream through ``ServeEngine``), on one GPU or, with ``--tp N``,
tensor-parallel over N ranks.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --batch 4 --prompt-len 64 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --no-reduced --continuous --requests 6 --slots 4 --prompt-len 1024 \
        --new-tokens 16 [--compress-weights [--weight-backend unpack]] \
        [--no-prefix-sharing]
    PYTHONPATH=src python -m repro_torch.launch.serve --disagg \
        --prefill-replicas 1 --decode-replicas 2 --streaming --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --continuous --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 \
        --dist-backend gloo --device cpu [--continuous [--compress-weights]]
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 \
        --dist-backend gloo --device cpu --arch seamless-m4t-large-v2

``--arch`` takes every config.  The dense, hybrid, MoE (MLA included:
deepseek-v2-lite-16b; jamba-tiny-dev, granite-moe-1b-a400m) and
attention-free (mamba2-370m) ones serve in all three modes.  The
vision-stub VLM (internvl2-76b) and the encoder-decoder
(seamless-m4t-large-v2) serve in fixed-batch mode only, as in the
reference: their stub inputs are drawn after the prompts from the same
generator -- ``front_embeds`` (B, n_frontend_tokens, d), then
``enc_embeds`` (B, prompt-len, d), N(0, 1) in bf16 -- and ``--continuous``
/ ``--disagg`` refuse them (``ServeEngine`` raises).

Weights are a seeded random init (no checkpoint ships with the repo).
``--reduced`` (the default) serves ``make_reduced(cfg)``; ``--no-reduced``
serves the published width.  ``--device cpu`` runs the kernels' plain
versions on the CPU.  Fixed-batch mode with ``--codec full`` uses
32-token cache blocks, as the reference does, so the default 64 + 32-token
run decodes from full compressed blocks.  ``--disagg`` serves the
continuous mode's stream through prefill -> decode replicas in one
process, joined by the loopback page transport (multi-process serving:
``repro_torch.launch.disagg_host``).

``--tp N`` spawns N ranks (``launch.mesh.spawn``), joined over
``--dist-backend``: ``nccl`` (one card per rank) or ``gloo`` (CPU tensors,
or CUDA tensors staged through host memory, e.g. two ranks on one card,
which NCCL refuses).  Each rank serves the same requests on its shard of
the weights (the seed's tp = 1 weights padded for tp, ``models.params.
pad_for_tp``); rank 0 prints.  Every family: a dense model (the VLM and
the encoder-decoder too: every rank draws the same stub inputs, after
the same prompts) is the same function at every tp, so it prints tp =
1's continuations up to near-ties, while the SSM (mamba2-370m too) and
MoE families (MLA's too) compute the reference's tp-dependent function
(``models/ssm.py``, ``models/moe.py``) and print tp's own.  ``--disagg
--tp N`` runs every replica of the fleet on the N ranks
(``DisaggEngine(group=)``).
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
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="continuous mode: disable prefix-cache page "
                         "sharing between requests")
    ap.add_argument("--disagg", action="store_true",
                    help="serve through disaggregated prefill->decode "
                         "replicas over compressed page transfer")
    ap.add_argument("--prefill-replicas", type=int, default=1,
                    help="--disagg: number of prefill replicas")
    ap.add_argument("--decode-replicas", type=int, default=1,
                    help="--disagg: number of decode replicas")
    ap.add_argument("--streaming", action="store_true",
                    help="--disagg: stream full compressed pages across "
                         "the transfer link as admission fills them; "
                         "multi-process serving lives in "
                         "repro_torch.launch.disagg_host")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (one process each)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default=None,
                    help="--tp > 1: the process group's backend (nccl: "
                         "one card per rank; gloo: CPU, or ranks sharing "
                         "a card); required with --tp > 1")
    args = ap.parse_args(argv)
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.tp > 1 and args.dist_backend is None:
        ap.error("--tp > 1 needs --dist-backend nccl or gloo")

    codec = (CodecConfig() if args.codec == "full" else CodecConfig.off())
    run = RunConfig(codec=dataclasses.replace(
        codec, decode_backend=args.decode_backend,
        weight_backend=args.weight_backend))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    if args.compress_weights and not (args.continuous or args.disagg):
        ap.error("--compress-weights needs --continuous or --disagg")
    if args.tp > 1:
        return _spawn_ranks(cfg, run, args)
    if args.continuous or args.disagg:
        return _serve_continuous(cfg, run, args)
    return _serve_fixed(cfg, run, args)


def _spawn_ranks(cfg, run: RunConfig, args) -> int:
    """Serve on ``--tp`` spawned ranks (rank 0 prints)."""
    import torch
    from repro_torch.launch import mesh

    device = args.device
    if torch.device(device).type == "cuda" and args.dist_backend == "nccl" \
            and torch.cuda.device_count() < args.tp:
        raise SystemExit(f"--dist-backend nccl needs one card per rank: "
                         f"{args.tp} ranks, {torch.cuda.device_count()} "
                         "cards (two ranks may share a card over gloo)")
    codes = mesh.spawn(_rank, args.tp, backend=args.dist_backend,
                       device=device, args=(cfg, run, args))
    return max(codes)


def _rank(tg, cfg, run: RunConfig, args) -> int:
    """One rank of ``--tp``: its card (rank modulo the cards), then the
    mode's loop; only rank 0 prints."""
    import contextlib
    import io

    quiet = tg.rank != 0
    with contextlib.redirect_stdout(io.StringIO()) if quiet \
            else contextlib.nullcontext():
        if args.continuous or args.disagg:
            return _serve_continuous(cfg, run, args, tg)
        return _serve_fixed(cfg, run, args, tg)


def _rank_device(args, tg):
    """The rank's device: its group's (``mesh.rank_device``: a CUDA
    device is card rank modulo the cards), else ``--device``."""
    import torch

    return torch.device(args.device) if tg is None else tg.device


def _serve_fixed(cfg, run: RunConfig, args, tg=None) -> int:
    """Prefill ``--batch`` prompts and decode them greedily in lockstep,
    once to warm up (kernel build, allocator) and once timed."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm, params as PM
    from repro_torch.serve import engine

    if run.codec.cache:
        run = dataclasses.replace(run, codec=dataclasses.replace(
            run.codec, cache_block=32))
    device = engine.resolve_device(_rank_device(args, tg))
    ops.resolve_decode_backend(run.codec, device)
    if device.type == "cuda":
        # f32 products (prefill attention) stay f32, as in the reference
        torch.backends.cuda.matmul.allow_tf32 = False
    b, s, n = args.batch, args.prompt_len, args.new_tokens
    tp = 1 if tg is None else tg.world
    if s % tp:
        raise SystemExit(f"--prompt-len {s} must be a multiple of --tp {tp} "
                         "in fixed-batch mode")
    max_len = s + n + run.codec.cache_block * tp
    params = PM.init_params(
        lm.lm_table(cfg), torch.Generator(device=device).manual_seed(run.seed),
        device=device)
    if tp > 1:
        params = PM.shard_params(PM.pad_for_tp(params, cfg, tp),
                                 lm.lm_table(cfg, tp), tp, tg.rank)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                              dtype=torch.int32, device=device)
    extras = stub_inputs(cfg, rng, b, s, device)

    def serve():
        return engine.generate(cfg, run, params, prompts, n, max_len,
                               tg, **extras).cpu()

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
          f"cache block {run.codec.cache_block}, tp {tp}")
    print("[serve] sample continuations:", out[:2, :12].tolist())
    return 0


def stub_inputs(cfg, rng, batch: int, prompt_len: int, device) -> dict:
    """The fixed loop's stub inputs, drawn from ``rng`` (after the
    prompts) in the reference launcher's order: a vision-stub VLM's
    ``front_embeds`` (B, n_frontend_tokens, d), then an encoder-decoder's
    ``enc_embeds`` (B, prompt_len, d), N(0, 1) rounded to bf16."""
    import torch

    def normal(shape):
        return torch.as_tensor(rng.normal(0, 1, shape), dtype=torch.float32,
                               device=device).to(torch.bfloat16)

    extras = {}
    if cfg.frontend == "vision_stub":
        extras["front_embeds"] = normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model))
    if cfg.encdec:
        extras["enc_embeds"] = normal((batch, prompt_len, cfg.d_model))
    return extras


def _serve_continuous(cfg, run: RunConfig, args, tg=None) -> int:
    """Request-stream mode; with --disagg the stream runs through prefill
    -> decode replicas joined by compressed page transfer."""
    from repro_torch.serve.scheduler import (ServeEngine, demo_serving_setup,
                                             format_stats)
    tp = 1 if tg is None else tg.world
    run, max_len, reqs = demo_serving_setup(
        run, cfg.vocab_size, args.prompt_len, args.new_tokens, args.requests,
        tp=tp)
    stops = ([tuple(int(t) for t in args.stop_seq.split(","))]
             if args.stop_seq else None)
    if args.disagg:
        from repro_torch.serve.disagg import DisaggEngine, format_disagg_stats
        eng = DisaggEngine(cfg, run, group=tg,
                           n_prefill=args.prefill_replicas,
                           n_decode=args.decode_replicas,
                           n_slots=args.slots, max_len=max_len,
                           seed=run.seed, eos_id=args.eos_id,
                           stop_seqs=stops, streaming=args.streaming,
                           compress_weights=args.compress_weights,
                           device=_rank_device(args, tg))
        results, st = eng.run(reqs)
        print(f"[serve] disagg (tp {tp}):", format_disagg_stats(st))
    else:
        eng = ServeEngine(cfg, run, group=tg, n_slots=args.slots,
                          max_len=max_len, seed=run.seed, eos_id=args.eos_id,
                          stop_seqs=stops,
                          prefix_sharing=not args.no_prefix_sharing,
                          compress_weights=args.compress_weights,
                          device=_rank_device(args, tg))
        results, st = eng.run(reqs)
        print(f"[serve] continuous (tp {tp}):", format_stats(st))
    print("[serve] sample continuations:",
          [(r.tokens[:6], r.stop_reason) for r in results[:2]])
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
