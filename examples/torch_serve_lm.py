"""Batched serving with LEXI on every transport, on PyTorch: compressed
weights at rest, the compressed block KV cache, compressed activation
collectives (ports ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma2-9b
    PYTHONPATH=src python examples/torch_serve_lm.py --continuous
    PYTHONPATH=src python examples/torch_serve_lm.py --disagg \\
        --tp 2 --dist-backend gloo
    PYTHONPATH=src python examples/torch_serve_lm.py --tp 2 \\
        --dist-backend gloo --arch seamless-m4t-large-v2

The fixed batch (the default) prefills ``--batch`` prompts and decodes
them greedily in lockstep.  ``--continuous`` runs a request stream
(mixed prompt lengths, more requests than decode slots) through the
continuous-batching engine, and ``--disagg`` the same stream through a
prefill replica feeding a decode replica over compressed page transfer.
``--tp N --dist-backend nccl|gloo`` spawns N tensor-parallel ranks (the
reference's mesh model axis; gloo for ranks that share a card or the
CPU); rank 0 prints.  ``--device`` is ``cuda`` (the default) or ``cpu``.
The model is ``make_reduced(arch, tp=N)`` with seeded random weights;
every family serves at every tp (the encoder-decoder and the vision-stub
VLM on the fixed batch only, with the launcher's stub inputs).

Prints each transport's compression accounting beside throughput.
"""

import argparse
import contextlib
import io
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def serve(tg, args) -> int:
    """One rank's run (``tg`` None at tp = 1)."""
    from repro_torch.configs import get_config, make_reduced
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import weights as W
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.core.fixed import wire_ratio
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import lm, params as PM
    from repro_torch.serve import engine

    tp = 1 if tg is None else tg.world
    device = engine.resolve_device(args.device if tg is None else tg.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    run = RunConfig(codec=CodecConfig(cache_block=32))
    cfg = make_reduced(get_config(args.arch), tp=tp)
    b, s, n = args.batch, args.prompt_len, args.new_tokens

    if args.continuous or args.disagg:
        from repro_torch.serve import ServeEngine
        from repro_torch.serve.scheduler import demo_serving_setup, \
            format_stats
        run, max_len, reqs = demo_serving_setup(
            run, cfg.vocab_size, s, n, args.requests, tp=tp)
        if args.disagg:
            from repro_torch.serve.disagg import DisaggEngine, \
                format_disagg_stats
            eng = DisaggEngine(cfg, run, group=tg, n_prefill=1, n_decode=1,
                               n_slots=args.slots, max_len=max_len, seed=0,
                               device=device)
            results, st = eng.run(reqs)
            print("[serve] disagg:", format_disagg_stats(st))
        else:
            eng = ServeEngine(cfg, run, group=tg, n_slots=args.slots,
                              max_len=max_len, seed=0, device=device,
                              prefix_sharing=not args.no_prefix_sharing)
            results, st = eng.run(reqs)
            print("[serve] continuous:", format_stats(st))
        print("[serve] continuations[0][:10] =", results[0].tokens[:10])
        return 0

    params = PM.init_params(lm.lm_table(cfg), torch.Generator(
        device=device).manual_seed(0), device=device)
    if tp > 1:
        params = PM.shard_params(PM.pad_for_tp(params, cfg, tp),
                                 lm.lm_table(cfg, tp), tp, tg.rank)

    # --- compression accounting (this rank's shard) ----------------------
    cp = W.compress_params(params, run.codec)
    raw, stored = W.param_bytes(params), W.stored_bytes(cp)
    cache_raw = b * (s + n) * cache_mod.kv_width(cfg) * 2 * cfg.n_layers
    print(f"[serve] weights at rest : {raw / 1e6:.1f} MB -> "
          f"{stored / 1e6:.1f} MB ({raw / stored:.2f}x, LEXI-FW)")
    print(f"[serve] KV cache (raw {cache_raw / 1e6:.2f} MB) stored packed "
          f"at ~{wire_ratio(run.codec.k):.2f}x")
    print(f"[serve] activations packed at ~{wire_ratio(run.codec.k):.2f}x on "
          f"every all_gather / all_to_all between the {tp} rank(s)")
    del cp

    if s % tp:
        raise SystemExit(f"--prompt-len {s} must be a multiple of --tp {tp}")
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                              dtype=torch.int32, device=device)
    # a VLM's front embeds or an encoder-decoder's frames, after the
    # prompts, the same on every rank
    extras = stub_inputs(cfg, rng, b, s, device)
    max_len = s + n + run.codec.cache_block * tp

    def go():
        return engine.generate(cfg, run, params, prompts, n, max_len,
                               tg, **extras).cpu()

    go()                                       # build, warm up
    t0 = time.perf_counter()
    out = go()
    dt = time.perf_counter() - t0
    print(f"[serve] {b} x ({s}+{n}) tokens at tp {tp}, steady state "
          f"{b * n / dt:.1f} tok/s on {device}")
    print(f"[serve] continuations[0][:10] = {out[0, :10].tolist()}")
    return 0


def _rank(tg, args) -> int:
    with contextlib.redirect_stdout(io.StringIO()) if tg.rank \
            else contextlib.nullcontext():
        return serve(tg, args)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--continuous", action="store_true",
                    help="run a request stream through the "
                         "continuous-batching engine")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable prefix-cache page sharing (continuous)")
    ap.add_argument("--disagg", action="store_true",
                    help="continuous mode through disaggregated prefill->"
                         "decode replicas over compressed page transfer")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (one process each)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="--tp > 1: nccl (one card per rank) or gloo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    if args.tp == 1:
        return serve(None, args)
    if args.dist_backend is None:
        ap.error("--tp > 1 needs --dist-backend nccl or gloo")
    from repro_torch.launch import mesh
    return max(mesh.spawn(_rank, args.tp, backend=args.dist_backend,
                          device=args.device, args=(args,)))


if __name__ == "__main__":
    raise SystemExit(main())
