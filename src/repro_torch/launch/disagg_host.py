"""Multi-process disaggregated serving (ports ``repro/launch/disagg_host.py``):
decode-replica hosts in their own OS processes, fed by a driver over the
socket page transport.

Roles:

  decode   — build a decode replica and serve it behind a TCP listener
             (``serve.net.server.PageHost``).  Prints one ``READY host=...
             port=... params=...`` line once listening (``--port 0`` picks a
             free port; ``params`` is ``param_digest`` of its weights), then
             handles driver sessions.
  driver   — build prefill replicas and a ``DisaggEngine`` whose decode
             replicas are remote (``--decode-addr host:port[,...]``), run
             a shared-prefix demo request stream through the socket, and
             print the link accounting.  ``--check`` also runs the
             monolithic engine and requires identical token streams.
  selftest — spawn one decode host as a child process and run the driver
             against it with ``--check`` (exit code 0: the weights of both
             processes are equal and the streams identical across the
             socket).

``--tp N --dist-backend gloo|nccl`` runs either role on N ranks
(``launch.mesh.spawn``): each rank holds its shard of every replica, a
decode host's rank 0 holds the socket and runs each call on every rank
(``serve.disagg.GroupReplica``), a driver's rank 0 talks to the hosts
and hands every rank their answers; the blobs carry every rank's pages
(an attention-free model's, every rank's SSM state: ``--arch
mamba2-370m``).

Both processes must be launched with the same model, codec, geometry and
seed flags (``--tp`` too): the hello handshake compares a configuration
fingerprint (``serve.net.framing.config_fingerprint``, the reference's
bytes) and refuses the session otherwise. Each process draws its weights
from the seed on its own device (``--device``, default ``cuda``; a
missing GPU raises). The backends default to ``auto``, the only value
the reference shares, so that a reference driver and a port host agree
on the fingerprint.

    PYTHONPATH=src python -m repro_torch.launch.disagg_host --role decode \\
        --model tiny-bench --codec on --port 7070
    PYTHONPATH=src python -m repro_torch.launch.disagg_host --role driver \\
        --model tiny-bench --codec on --decode-addr 127.0.0.1:7070 --check
    PYTHONPATH=src python -m repro_torch.launch.disagg_host --selftest \\
        --device cpu [--tp 2 --dist-backend gloo] [--arch mamba2-370m]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import queue
import re
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


def tiny_bench_config():
    """The reference serving bench's tiny dense model
    (``repro/launch/disagg_host.py:tiny_bench_config``)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name="bench", family="dense", n_layers=2, d_model=64,
                       n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=512,
                       head_dim=16)


def build_cfg_run(args):
    """(cfg, run) from the shared model flags: deterministic in the flags
    alone, both processes call it."""
    from repro_torch.configs import get_config, make_reduced
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.collectives import CodecConfig
    if args.model == "tiny-bench":
        cfg = tiny_bench_config()
    elif args.reduced:
        cfg = make_reduced(get_config(args.model), tp=args.tp)
    else:
        cfg = get_config(args.model)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    codec = (CodecConfig(cache_block=args.cache_block) if args.codec == "on"
             else dataclasses.replace(CodecConfig.off(),
                                      cache_block=args.cache_block))
    codec = dataclasses.replace(codec, decode_backend=args.decode_backend,
                                weight_backend=args.weight_backend)
    return cfg, RunConfig(codec=codec)


def _fingerprint(args, cfg, run) -> bytes:
    from repro_torch.serve.net.framing import config_fingerprint
    return config_fingerprint(cfg, run.codec, args.tp, args.slots,
                              args.max_len, args.seed, eos_id=args.eos_id)


def param_digest(params) -> str:
    """A short digest of a parameter tree's bits, reduced on each leaf's
    device so two processes can check that they drew the same weights
    without copying them to the host.  Per leaf tensor (in path order): its
    shape and dtype, and two exact sums of its bits (as 16-bit words, or
    bytes for 1-byte dtypes) weighted by position, ``(i mod 65521) + 1``
    and ``(i mod 65519) + 1``.  The weights tell apart any two positions
    closer than their product (~4.3e9 words), so a permutation or a pair
    of compensating changes within a leaf changes the digest."""
    import torch
    h = hashlib.sha256()
    chunk = 1 << 24                      # words per reduction: sums < 2^62

    def sums(t):
        flat = t.detach().reshape(-1).contiguous()
        words = flat.view(torch.uint8 if flat.element_size() == 1
                          else torch.int16)
        s1 = s2 = 0
        for lo in range(0, words.numel(), chunk):
            x = words[lo:lo + chunk].to(torch.int64)
            i = torch.arange(lo, lo + x.numel(), device=x.device,
                             dtype=torch.int64)
            s1 += int((x * (i % 65521 + 1)).sum())
            s2 += int((x * (i % 65519 + 1)).sum())
        return s1, s2

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}/{key}")
        elif isinstance(node, torch.Tensor):
            h.update(f"{path}:{tuple(node.shape)}:{node.dtype}:"
                     f"{sums(node)};".encode())
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), f"{path}.{f.name}")
        else:
            h.update(f"{path}={node!r};".encode())

    walk(params, "")
    return h.hexdigest()[:16]


def demo_requests(cfg, args) -> List:
    """Deterministic shared-prefix request mix (duplicates and a fork,
    staggered budgets) sized to the --max-len pool: the reference's."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(args.seed)
    v = cfg.vocab_size
    plen = min(args.prompt_len, args.max_len - 2 * args.new_tokens)
    plen = max(plen, args.tp)
    base_a = rng.integers(0, v, (plen,)).astype(np.int32)
    base_b = rng.integers(0, v, (max(args.tp, plen * 2 // 3),)
                          ).astype(np.int32)
    forked = np.concatenate([base_a[:plen * 2 // 3],
                             rng.integers(0, v, (plen - plen * 2 // 3,)
                                          ).astype(np.int32)])
    prompts = [base_a, base_b, base_a, forked]
    return [Request(uid=i, prompt=prompts[i % len(prompts)],
                    max_new_tokens=args.new_tokens * (2 if i % 2 == 0
                                                      else 1))
            for i in range(args.requests)]


# ---------------------------------------------------------------------------
# roles
# ---------------------------------------------------------------------------


def _on_ranks(role, args, *extra) -> int:
    """Run ``role(args, *extra, tg=...)`` on ``--tp`` spawned ranks (one
    rank: in this process); rank 0 prints."""
    if args.tp == 1:
        return role(args, *extra)
    from repro_torch.launch import mesh
    return max(mesh.spawn(_rank, args.tp, backend=args.dist_backend,
                          device=args.device, args=(role, args) + extra))


def _rank(tg, role, args, *extra) -> int:
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()) if tg.rank \
            else contextlib.nullcontext():
        return role(args, *extra, tg=tg)


def _device(args, tg):
    import torch
    return torch.device(args.device) if tg is None else tg.device


def run_decode_host(args, tg=None) -> int:
    """Serve one decode replica behind a TCP listener; at tp > 1 rank 0
    listens and the other ranks follow its calls."""
    from repro_torch.serve import DecodeReplica, PageHost, ServeEngine
    from repro_torch.serve.disagg import GroupReplica, follow
    cfg, run = build_cfg_run(args)
    eng = ServeEngine(cfg, run, tp=args.tp, group=tg, n_slots=args.slots,
                      max_len=args.max_len, seed=args.seed,
                      eos_id=args.eos_id, store_pages=args.store_pages,
                      compress_weights=args.compress_weights,
                      device=_device(args, tg))
    replica = DecodeReplica(eng)
    if tg is not None and tg.rank:
        follow(replica, tg)
        return 0
    if tg is not None:
        replica = GroupReplica(replica, tg)
    host = PageHost(replica, _fingerprint(args, cfg, run),
                    max_store_pages=args.store_pages)
    if tg is not None:
        # the transport store lives on rank 0: no remote tier at tp > 1
        eng.cache.remote_fetch = None
    listener = socket.create_server((args.host, args.port))
    actual = listener.getsockname()[1]
    print(f"READY host={args.host} port={actual} "
          f"params={param_digest(eng.params)}", flush=True)
    try:
        host.serve_forever(listener, once=args.once)
    finally:
        listener.close()
        if tg is not None:
            replica.close()
    return 0


def run_driver(args, expect_params: Optional[str] = None, tg=None) -> int:
    """Serve the demo stream through remote decode hosts.  With
    ``expect_params`` (a host's ``param_digest``; at tp > 1 its rank 0's)
    the driver's own weights (rank 0's) must have the same digest."""
    from repro_torch.core import collectives as cl
    from repro_torch.serve import DisaggEngine, ServeEngine, SocketTransport
    from repro_torch.serve.disagg import format_disagg_stats
    from repro_torch.serve.telemetry import Tracer
    cfg, run = build_cfg_run(args)
    addrs = [a for a in args.decode_addr.split(",") if a]
    root = tg is None or tg.rank == 0
    tracer = Tracer(enabled=args.trace_out is not None and root)
    eng = DisaggEngine(cfg, run, tp=args.tp, group=tg,
                       n_prefill=args.prefill_replicas,
                       n_slots=args.slots, max_len=args.max_len,
                       seed=args.seed, eos_id=args.eos_id,
                       transport=SocketTransport() if root else None,
                       streaming=args.streaming, decode_addrs=addrs,
                       store_pages=args.store_pages,
                       compress_weights=args.compress_weights,
                       tracer=tracer, device=_device(args, tg))
    if expect_params is not None:
        mine = cl.broadcast_object(param_digest(eng.params) if root
                                   else None, tg)
        if mine != expect_params:
            print(f"[disagg_host] PARAMS MISMATCH: driver {mine}, decode "
                  f"host {expect_params}")
            eng.transport.close()
            return 1
        print(f"[disagg_host] params equal in both processes ({mine})")
    reqs = demo_requests(cfg, args)
    results, st = eng.run(reqs)
    # fleet metrics fold the remote replicas' METRICS RPC snapshots, so
    # query them before the session closes
    snap = eng.metrics_snapshot() if args.metrics_json else None
    eng.transport.close()
    if args.trace_out and root:
        tracer.write(args.trace_out)
        print(f"[disagg_host] trace -> {args.trace_out} "
              f"({len(tracer.events)} spans)")
    if snap is not None and root:
        import json
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=1)
        print(f"[disagg_host] metrics -> {args.metrics_json}")
    print("[disagg_host] socket:", format_disagg_stats(st))
    if args.check:
        mono = ServeEngine(cfg, run, tp=args.tp, group=tg,
                           n_slots=args.slots, max_len=args.max_len,
                           params=eng.params, eos_id=args.eos_id,
                           device=_device(args, tg))
        res_m, _ = mono.run(demo_requests(cfg, args))
        for x, y in zip(res_m, results):
            if x.tokens != y.tokens or x.stop_reason != y.stop_reason:
                print(f"[disagg_host] STREAM MISMATCH uid={x.uid}: "
                      f"mono={x.tokens} socket={y.tokens}")
                return 1
        print(f"[disagg_host] check ok: {len(results)} streams "
              "identical to the monolithic engine across the socket")
    return 0


# ---------------------------------------------------------------------------
# child-process helper (--selftest, tests, chip_smoke.py)
# ---------------------------------------------------------------------------


def spawn_decode_host(model_args: Sequence[str], *, timeout: float = 240.0
                      ) -> Tuple[subprocess.Popen, int, str]:
    """Start ``--role decode --port 0 --once`` as a child process with the
    given model flags; returns ``(proc, port, params)`` once it prints
    READY (``params``: its weights' ``param_digest``; the reference
    returns ``(proc, port)``).  Kills the child and raises on a startup
    failure.  The child ends with the first session; ``stop_child`` ends
    it sooner."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.launch.disagg_host",
           "--role", "decode", "--port", "0", "--once", *model_args]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # a reader thread enforces the timeout even while the child is silent,
    # and keeps draining after READY so the child never blocks on a full
    # pipe
    out_q: "queue.Queue[Optional[str]]" = queue.Queue()

    def _reader():
        for line in proc.stdout:
            out_q.put(line)
        out_q.put(None)

    threading.Thread(target=_reader, daemon=True).start()
    ready = None
    lines: List[str] = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            line = out_q.get(timeout=min(1.0, max(deadline - time.time(),
                                                  0.01)))
        except queue.Empty:
            continue
        if line is None:
            break                        # child died before READY
        lines.append(line)
        ready = re.match(r"READY host=\S+ port=(\d+) params=(\w+)", line)
        if ready:
            break
    if not ready:
        proc.kill()
        proc.wait()
        raise RuntimeError("decode host failed to start:\n"
                           + "".join(lines[-30:]))
    return proc, int(ready.group(1)), ready.group(2)


def stop_child(proc: subprocess.Popen) -> None:
    """End a spawned decode host and reap it."""
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def run_selftest(args) -> int:
    model_args = ["--model", args.model, "--codec", args.codec,
                  "--cache-block", str(args.cache_block),
                  "--slots", str(args.slots), "--max-len", str(args.max_len),
                  "--seed", str(args.seed),
                  "--decode-backend", args.decode_backend,
                  "--weight-backend", args.weight_backend,
                  "--store-pages", str(args.store_pages),
                  "--device", args.device, "--tp", str(args.tp)]
    if args.dist_backend is not None:
        model_args += ["--dist-backend", args.dist_backend]
    if not args.reduced:
        model_args += ["--no-reduced"]
    if args.layers is not None:
        model_args += ["--layers", str(args.layers)]
    if args.compress_weights:
        model_args += ["--compress-weights"]
    if args.eos_id is not None:
        model_args += ["--eos-id", str(args.eos_id)]
    proc, port, params = spawn_decode_host(model_args)
    try:
        args.decode_addr = f"127.0.0.1:{port}"
        args.check = True
        return _on_ranks(run_driver, args, params)
    finally:
        stop_child(proc)


def main(argv=None) -> int:
    from repro_torch.kernels.ops import DECODE_BACKENDS, WEIGHT_BACKENDS
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default=None,
                    choices=["decode", "driver"],
                    help="decode: serve a replica behind a TCP port; "
                         "driver: run requests through remote replicas")
    ap.add_argument("--selftest", action="store_true",
                    help="spawn one decode child and run the driver with "
                         "--check (the two-process smoke test)")
    # shared model / geometry flags: they must match across processes (the
    # hello handshake compares a configuration fingerprint)
    ap.add_argument("--model", "--arch", dest="model", default="tiny-bench",
                    help="'tiny-bench' or a named arch")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="a named arch at make_reduced's size (default) "
                         "or its published width (--no-reduced)")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the model at this depth (its first layers' "
                         "shapes, the width kept)")
    ap.add_argument("--codec", default="on", choices=["on", "off"])
    ap.add_argument("--cache-block", type=int, default=8)
    ap.add_argument("--decode-backend", default="auto",
                    choices=list(DECODE_BACKENDS))
    ap.add_argument("--compress-weights", action="store_true",
                    help="serve from the LEXI-packed weight store (both "
                         "replica kinds; the same streams)")
    ap.add_argument("--weight-backend", default="auto",
                    choices=list(WEIGHT_BACKENDS))
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks of every replica (one "
                         "process each)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default=None,
                    help="--tp > 1: the process group's backend (gloo for "
                         "ranks that share a card or the CPU)")
    # decode-host flags
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = pick a free port (printed on the READY line)")
    ap.add_argument("--once", action="store_true",
                    help="exit after the first driver session ends")
    ap.add_argument("--store-pages", type=int, default=4096,
                    help="LRU cap (pages) of the content-addressed stores: "
                         "the transport digest store and the engine "
                         "PageCache warm tier")
    # driver flags
    ap.add_argument("--decode-addr", default=None,
                    help="comma-separated host:port decode hosts")
    ap.add_argument("--prefill-replicas", type=int, default=1)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--streaming", action="store_true", default=True,
                    help="stream full pages during admission (default)")
    ap.add_argument("--no-streaming", dest="streaming",
                    action="store_false")
    ap.add_argument("--check", action="store_true",
                    help="driver: also run the monolithic engine and "
                         "require identical token streams")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="driver: write a Chrome trace-event JSON of the "
                         "request lifecycle spans here")
    ap.add_argument("--metrics-json", type=str, default=None,
                    help="driver: write the fleet-merged metrics snapshot "
                         "(local registries and each host's METRICS RPC) "
                         "here")
    args = ap.parse_args(argv)

    if args.tp > 1 and args.dist_backend is None:
        ap.error("--tp > 1 needs --dist-backend nccl or gloo")
    if args.selftest:
        return run_selftest(args)
    if args.role == "decode":
        return _on_ranks(run_decode_host, args)
    if args.role == "driver":
        if not args.decode_addr:
            ap.error("--role driver needs --decode-addr")
        return _on_ranks(run_driver, args)
    ap.error("pick --role decode|driver or --selftest")


if __name__ == "__main__":
    sys.exit(main())
