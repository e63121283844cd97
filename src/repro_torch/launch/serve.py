"""Continuous-batching serving demo on one GPU (ports the ``--continuous``
path of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --no-reduced --continuous --requests 6 --slots 4 --prompt-len 1024 \
        --new-tokens 16

Weights are a seeded random init (no checkpoint ships with the repo).
``--reduced`` (the default) serves ``make_reduced(cfg)``; ``--no-reduced``
serves the published width.  ``--device cpu`` runs the kernels' plain
versions on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config, make_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.core.collectives import CodecConfig
from repro_torch.kernels.ops import DECODE_BACKENDS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--codec", default="full", choices=["full", "off"])
    ap.add_argument("--continuous", action="store_true", required=True,
                    help="serve a request stream through the "
                         "continuous-batching engine (the only mode ported)")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of queued requests")
    ap.add_argument("--slots", type=int, default=4, help="decode slots")
    ap.add_argument("--decode-backend", default="auto",
                    choices=list(DECODE_BACKENDS),
                    help="decode attention: auto (by device), cuda (the "
                         "kernel; needs --device cuda) or torch (the plain "
                         "version; needs --device cpu)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="evict a slot when it emits this token id")
    ap.add_argument("--stop-seq", type=str, default=None,
                    help="comma-separated token ids; a slot stops when its "
                         "stream ends with them (stop_reason=stop_string)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.serve.scheduler import (ServeEngine, demo_serving_setup,
                                             format_stats)
    codec = (CodecConfig() if args.codec == "full" else CodecConfig.off())
    run = RunConfig(codec=dataclasses.replace(
        codec, decode_backend=args.decode_backend))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    run, max_len, reqs = demo_serving_setup(
        run, cfg.vocab_size, args.prompt_len, args.new_tokens, args.requests)
    stops = ([tuple(int(t) for t in args.stop_seq.split(","))]
             if args.stop_seq else None)
    eng = ServeEngine(cfg, run, n_slots=args.slots, max_len=max_len,
                      seed=run.seed, eos_id=args.eos_id, stop_seqs=stops,
                      device=args.device)
    results, st = eng.run(reqs)
    print("[serve] continuous:", format_stats(st))
    print("[serve] sample continuations:",
          [(r.tokens[:6], r.stop_reason) for r in results[:2]])
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
