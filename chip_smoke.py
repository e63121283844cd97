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
               and the pack, rtol = atol = 1e-4 for paged attention, also
               where two slots hold the same page-table row, q, ring and
               length (as after a prefix hit: their outputs equal bit for
               bit).
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
               seed; phases 5-8 serve with ``prefix_sharing=False``, as
               before sharing was ported, so that their numbers stay
               comparable), eagerly (``cuda_graphs=False``: the flush check
               reads the card inside the step): 6 mixed requests over 4 slots,
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
               the paged kernel launched once per layer and step; tok/s
               and TTFT beside the serve phase's eager run's.
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
               serve phase's weights (their first 12 of 36 layers,
               ``PREFIX_LAYERS``): 4 prompts of 1000 tokens, 40 greedy
               steps at block 256, so the rings flush at 1024.  Each
               layer's ``decode_attend`` launches once per step; the
               flushed block of layers 0 and 11 decodes bit for bit to its
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
               packed fields of ``blocks.mlp.w_gate`` (its first 4 layers)
               and ``lm_head`` byte-identical to the same leaves packed on
               the CPU; then
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
  9. prefix  — prefix sharing and the tiered PageCache on the serve
               phase's raw weights (their first 12 of 36 layers,
               ``PREFIX_LAYERS``), block 256, 4 slots of 4096 tokens (72
               pool columns): a 20-request mix (``prefix_mix``: 4
               2048-token system prompts in 3 rounds with seeded user
               tails of 64-448 tokens, 6 unrelated 2048-token prompts that
               press on the pool, two exact duplicates) from CUDA graphs
               with the path's kernels counted in that run: every budget
               met, hits, fewer admissions than requests, evictions, each
               duplicate's stream equal to its original's; then every
               retained column evicted and the duplicates served again
               from the warm tier (no prefill, the same streams, every
               imported page's bytes hashing to its spilled digest); the
               mix with sharing off (the share of equal tokens, and each
               divergence teacher-forced through both runs' paths, which
               must be a near-tie); the first 6 requests eagerly and from
               graphs (streams, page table, page use, pool and ring bytes
               equal); the launcher's tail-free demo mix on and off (the
               replay cost of a hit; divergences near-ties).  Prints tok/s,
               TTFT, admissions, hits, spilled and fetched pages and
               bytes, evicted columns, and ms per column spilled and
               imported.
  10. disagg — disaggregated serving on qwen3-4b's first 12 layers
               (``PREFIX_LAYERS``, full width, seed 0's weights), block
               256, 4 slots of 2048 tokens per replica, on the
               launcher's tail-free demo mix (repeated prompts: wire
               dedup and import prefix hits) and the serve phase's mix
               (rings cross half full), each four ways from CUDA graphs:
               (a) ``DisaggEngine`` 1 prefill -> 1 decode replica over the
               loopback transport, (b) the same streaming pages during
               admission, (c) 1 prefill -> 2 decode replicas, (d) the
               decode replica in a second process on the card
               (``launch.disagg_host.spawn_decode_host``, its weights'
               ``param_digest`` equal to this process's) over TCP,
               streaming.  The streams of (a)-(d) equal bit for bit, every
               budget met, (b) and (d) the same wire-byte counters; every
               page in the receivers' stores hashes to its digest; each
               handoff of (a) exported again from the decode replica
               right after its import equals the blob (ring, length,
               tokens, every imported column; without a prefix hit its
               ``to_wire`` bytes); against the monolithic engine (sharing
               off) the share of equal tokens, each divergence
               teacher-forced through both paths and required to be a
               near-tie.  Prints wire against raw bytes
               (``link_reduction``), codec-only bytes, dedup references,
               pages streamed and chunk bytes, the LinkModel's modelled
               ms (100 Gb/s chiplet link, not measured), export and import
               ms per column, transfer ms per handoff, tok/s and TTFT.
  11. hybrid — the parallel attention ∥ SSM hybrid, full-width
               zamba2-1.2b (its first ``HYBRID_LAYERS`` = 8 of 26
               layers, d 2048, 16/16 heads, hd 128, SSM
               d_inner 4096 = 64 heads x 64, d_state 64; random weights
               from seed 0), block 256: both attention kernels at its
               shapes (MHA, W 4096) within 1e-4 of their plain versions
               and timed beside SDPA, the codec pair exact on its pages;
               the reference tests' tiny hybrid (hymba_3global) on the card
               against the CPU, raw and packed (1e-2); the serve mix (6
               requests, 4 slots, exact trunks: no replay) eagerly and
               from CUDA graphs: streams, page table, pool bytes and SSM
               state bytes equal; 8 profiled decode steps of 4 fresh
               1000-token slots and the SSM work's device time alone
               (``chiprun_out/profile_decode_hybrid{,_graph}.txt``); a
               page-aligned prompt served twice with sharing on (the
               second a boundary-snapshot hit, no prefill, the same
               stream); 1 prefill -> 1 decode replica over the loopback
               (the monolithic streams, each imported SSM state equal to
               its export, the SSM section's wire bytes); the packed
               weight plane (``cuda``: both weight kernels, ``conv_x``
               through ``lexi_unpack``); the fixed loop 4 x 1000, graph ==
               eager byte for byte (SSM state included).
  12. moe_mla — MoE and the MLA latent path of both attention kernels:
               the kernels phase's attention checks (split edges, codec
               off, aliased slots, timed beside SDPA on the decompressed
               rows and the bound) at full-width deepseek-v2-lite-16b's
               MLA shapes (16 heads on one 576-wide latent row, values its
               first 512 columns) and at jamba-tiny-dev's (16/8 heads, hd
               64); a tiny MoE + MLA model on the card against the CPU, raw
               and packed (1e-2); then deepseek-v2-lite-16b (its first
               ``MOE_MLA_LAYERS`` = 9 of 27 layers, d 2048, 64 experts
               top-6 + 2 shared, random bf16 weights from seed 0), block
               256, 4 slots:
               the serve mix eagerly and from CUDA graphs (streams, page
               table, pool bytes equal; exact trunks), 8 profiled decode
               steps of 4 fresh 1000-token slots
               (``chiprun_out/profile_decode_moe_mla{,_graph}.txt``), the
               fixed loop 4 x 1000 graph == eager byte for byte, the serve
               mix through 1 prefill -> 1 decode replica (the monolithic
               streams), and the packed weight plane (both weight kernels
               on the router, N 64, ``w_dkv``, N 576, and a shared expert
               at M 4 and 1024; the first 3 requests ``unpack`` == raw and
               ``cuda`` with every divergence a near-tie; its decode step
               profiled, ``..._packed{,_graph}.txt``); last, jamba-tiny-dev
               (8 layers, attention ∥ Mamba2, 8 experts top-2) eagerly and
               from graphs (streams, pool bytes and SSM state equal).
  13. tp — tensor parallelism: full-width qwen3-4b (its first
     ``PREFIX_LAYERS`` = 12 of 36 layers) at tp = 2 as two
     ranks (``launch.mesh.spawn``) on the one card over gloo (NCCL
     refuses two ranks on one device, so the activations' packed wire
     buffers cross host memory: a check of function, not of link speed),
     from seed 0's weights (the tp = 1 weights padded for tp, each rank's
     shard).  The mix (6 whole-trunk prompts of 256-1024 tokens) raw and
     packed (``cuda`` weight backend) and the fixed loop (4 x 508 + 6
     steps, a flush at 510); both ranks' streams equal; each rank's
     packed shards (their tp = 2 shapes, ``weight_shapes(cfg, 2)``)
     through both weight kernels against their plain versions
     (``packed_leaf_checks``: decompress_matmul at M 4 and 1024,
     lexi_unpack on every stacked shard); the parent's tp = 1 streams
     of the same weights teacher-forced through tp = 2's raw and packed
     paged paths and its fixed loop: every logit gap within
     ``TP_GAP_FACTOR`` times the tp = 1 reorder gap (tp = 1's raw against
     its packed weights on the same tokens), each first divergence a
     near-tie; per prefill the activation gathers' wire bytes against
     raw bf16, the escape overflows, the compressed all-gather's ms
     against a raw one on this transport, ms per prefill and per decode
     step, the launches.  A disaggregated fleet (one prefill and one
     decode replica, codec on, loopback, streaming) serves the mix at
     tp = 1 in the parent and at tp = 2 on the ranks (``disagg_fleet``):
     the tp = 2 streams equal the monolithic tp = 2 engine's (a
     divergence only at a near-tie, its margin printed), both ranks
     equal; wire and raw bytes, ``link_reduction`` at tp 2 against tp 1,
     the export, chunk, transfer and import ms per handoff.  The kernels
     phase holds both attention kernels' shard path on every shard of tp
     2 and 4 and times one tp = 2 shard (``tp_attend_kernels``: rows 1t
     and 6t), likewise at the hybrids' heads (``hybrid_tp_kernels``: the
     paged kernel's rows 1zt, zamba2-1.2b, and 1jt, jamba-tiny-dev; the
     fixed kernel's, which jamba's fixed loop runs, 6jt) and on the MLA
     latent at deepseek-v2-lite's (``mla_tp_kernels``: rows 1mt, 6mt).
  14. tp_hybrid — the paper's hybrids at tp = 2, two ranks on the one
     card over gloo from seed 0's weights (each rank's tp = 2 shard of
     the tp = 1 tree): a tiny jamba-like model's logits on the card
     within 1e-2 of the same two ranks on the CPU (prefill + 10 steps,
     raw and packed); then jamba-tiny-dev (8 layers, attention ∥ Mamba2,
     8 experts top-2: expert parallelism over the compressed all-to-all)
     and zamba2-1.2b (its first 8 of 26 layers, ``TPH_LAYERS``; its 64
     SSM heads 32 a rank) and deepseek-v2-lite-16b (its first
     ``TPM_LAYERS`` = 4 of 27 layers: MLA's row-parallel latent, 8 of
     the 16 heads a rank, 64 experts over the all-to-all; ``TPM_MIX``: 4
     prompts of 255-767 tokens, 6 new tokens) at full width: 4 prompts
     of 255-1023 tokens (3 odd: their tails replay), 16 new tokens each,
     4 slots, raw and packed (``cuda``),
     zamba2's with prefix sharing on and a page-aligned prompt served
     twice (a snapshot hit on both ranks), jamba's and deepseek's fixed
     loops 4 x 508 + 6.  Both ranks' streams equal; packed against raw,
     each first divergence a near-tie; each rank's packed expert stacks
     and SSM shards through both weight kernels; per prefill the all-to-all's
     dispatch and return and the gathers' wire bytes against raw bf16
     (0 escape overflows in the all-to-alls), ms per prefill and per
     decode step, the launches.  tp = 1 is no yardstick for these
     families (the reference's tp = 2 function differs, ROADMAP.md
     section 3).
  15. train — training on the card: full-width qwen1.5-1.8b (its first
     ``TRAIN_LAYERS`` = 4 of 24 layers, random weights from seed 0, the
     same model at every mesh) through ``launch.train.train_loop``, two
     ranks on the one card over gloo (host-staged) in one spawn, global
     batch 4 x 512, codec full, remat on: mesh 2x1 (FSDP) 2 steps, mesh
     1x2 under the megatron strategy (sequence-parallel blocks, the
     vocab-parallel loss; vocab 151936 padded to 152064) 2 steps and
     under the fsdp strategy its step 0: per step loss, grad norm, lr,
     clip scale and ms, both ranks equal; the compressed collectives'
     wire bytes against raw bf16 by kind (``fsdp`` weight gathers,
     ``all_gather`` activation gathers, the ``loss`` gather, the
     ``grads`` sync) and their escape overflows (0); each rank's peak
     device memory against its state; the codec kernels' launches
     during each run (each > 0).  Step 0 again at mesh 1x1 in this
     process: 2x1's loss within 1e-4 and grad norm within 1e-2
     relative, megatron 1x2's within 1e-3 and 1e-2, fsdp 1x2's loss
     within 1e-4.  ``exp_histogram`` and ``lexi_pack`` bit for bit
     against their plain versions and ``lexi_unpack``'s round trip exact
     at the embedding's FSDP shard (1 x 155.6 M), the largest block
     shard and one rank's 1x2 activation gather (1 x 2.1 M: rows 2a, 3a,
     5a, with their launches per 1x2 step), timed beside their bounds
     and their plain versions (the histogram also beside a
     ``torch.bincount``).  Then checkpoint/restart through ``launch.train.main`` at
     the reduced size (2 ranks, 8 steps, a checkpoint every 4, a failure
     at step 6): LATEST reads step 8, the step-8 checkpoint restored and
     saved again to the same bytes, stored against raw bytes.
  16. families — the remaining families at tp = 1, full width, random
     weights from seed 0, codec on, block 256, 4 slots: the attention
     kernels at the new geometries (rows 1g, 1h: the paged kernel at
     gemma2-9b's heads, 16/8, hd 256, softcap 50, and hymba-1.5b's, 25
     query heads on 5 kv heads; 6g, 6v, 6x: the fixed kernel at gemma2's
     (4 x 4400, window 4096), internvl2-76b's (64/8, hd 128) and
     seamless-m4t-large-v2's cross attention over its encoder memory
     (16/16, hd 64, 4 x 512 rows, non-causal, the host-length launch its
     static length takes), each as the kernels phase holds and times
     qwen3-4b's); the tiny attention-free, enc-dec and VLM models on the
     card against the CPU (1e-2; the latter two on the fixed loop with
     their stub inputs); mamba2-370m (48 layers, no attention: no pages)
     on ``ServeEngine`` eagerly and from CUDA graphs (streams and SSM
     state equal), a ``DisaggEngine`` fleet (the monolithic streams; the
     handoff is the SSM state), the packed weight plane (both weight
     kernels on its leaves; near-ties only) and the fixed loop;
     seamless-m4t-large-v2 (24 + 24 layers; 4 x 512 encoder frames and
     prompts, 16 new tokens; the cross-attention store's stored and raw
     bytes) and internvl2-76b (``FAM_LAYERS``: 4 of 80; 512-token
     prompts, their first 256 positions front embeds) on the fixed loop,
     graph == eager; gemma2-9b (42 layers) on ``ServeEngine`` from CUDA
     graphs and the fixed loop 4 x 4200 (past its 4096 window);
     hymba-1.5b (32 layers) and granite-moe-1b-a400m (24 layers) on
     ``ServeEngine`` from CUDA graphs.  Each serving family's decode step
     profiled from its graph (host and busy ms a step).
  17. the card's line, the ``kernels`` JSON line (launches from the runs
     from CUDA graphs, the replays counted; the disagg, hybrid, moe_mla,
     tp, tp_hybrid, train and families phases' runs added), then the
     result line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
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


def attend_timing(phase: str, name: str, fn, lib_fn):
    """An attention kernel's and its SDPA yardstick's time, both ways (with
    the spin: device time, the JSON line's; without: as the events read
    when the host's launch is slower than the L2 flush), and the host's
    time per call of each."""
    t = dict(ms=cuda_ms(fn), library_ms=cuda_ms(lib_fn),
             ms_no_spin=cuda_ms(fn, spin=False),
             library_ms_no_spin=cuda_ms(lib_fn, spin=False),
             host_us=host_us(fn), library_host_us=host_us(lib_fn))
    log(phase, f"{name} timing: with the spin {t['ms']:.4f} ms (SDPA "
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

def _pages(gen, n_pages, blk, w, small=False):
    """K/V-like bf16 pages: normal values, one page with a moderate number
    of out-of-dictionary exponents (escapes within capacity) and one with
    far more distinct exponents than the side channel holds (overflow).
    With ``small`` both are built of bounded values (a filled dictionary
    with tiny escapes, ``attend_cases.overflowing``), whatever the width,
    so that outputs stay O(1) under a softcap and an absolute error means
    something."""
    import torch
    from repro_torch.kernels import attend_cases as AC
    if small:
        x = torch.randn((n_pages, blk, w), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        x[1] = AC.with_escapes(AC.dict_filled(gen, (blk, w)),
                               list(range(0, blk, 16)))
        x[2] = AC.overflowing(gen, (blk, w))
        return x
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


def sdpa_fn(q, rows, mla_lora=None):
    """The yardstick the port never calls: one SDPA (``enable_gqa``) call
    of q (S, H, hd) over K/V rows (S, T, Hkv * 2 * hd) already
    decompressed, or over MLA latent rows (S, T, hd): keys the whole row,
    values its first ``mla_lora`` columns, one kv head."""
    import torch
    s_, t, w = rows.shape
    hd = q.shape[-1]
    if mla_lora is not None:
        kk, vv = rows[:, None], rows[:, None, :, :mla_lora]
    else:
        kv = rows.reshape(s_, t, w // (2 * hd), 2, hd)
        kk, vv = kv[..., 0, :].transpose(1, 2), kv[..., 1, :].transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kk, vv, enable_gqa=True)


def attend_geom(cfg):
    """The attention kernels' operands at ``cfg``'s shapes: heads h over
    hkv kv heads, the query's width hd, the payload's width w, the output
    width hd_v, and the kernels' keyword arguments (head map, scale,
    ``mla_lora``).  MLA: one latent row of lora + rope columns that every
    head shares, values its first lora columns."""
    from types import SimpleNamespace
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.models import attention

    h = cfg.n_heads
    if cfg.mla is not None:
        lora = cfg.mla.kv_lora_rank
        w = lora + cfg.mla.qk_rope_dim
        return SimpleNamespace(h=h, hkv=1, hd=w, w=w, hd_v=lora, kw=dict(
            kv_idx=(), scale=attention.mla_scale(cfg), mla_lora=lora))
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return SimpleNamespace(h=h, hkv=hkv, hd=hd, w=2 * hkv * hd, hd_v=hd,
                           kw=dict(kv_idx=AC.kv_idx(h, hkv),
                                   scale=hd ** -0.5, mla_lora=None))


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
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    k = ATTEND_K
    rec = {}
    rec["decode_attend_paged"], rows, c = paged_attend_kernel(
        cfg, gen, "kernels")

    # exp_histogram and lexi_pack: exact, at the four shapes of the
    # encoder's callers; the JSON rows are the 16-page table's
    g, n = rows.shape
    shapes = codec_shapes(gen, rows, k)
    want = ref.histogram_ref(rows)
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
    rec.update(weight_kernels(cfg, gen))
    rec["decode_attend"] = fixed_attend_kernel(cfg, gen, "kernels",
                                               also=("gemma2-9b",))
    tp_attend_kernels(cfg, gen, "kernels")
    mla_tp_kernels(gen, "kernels")
    hybrid_tp_kernels(gen)
    return rec


# (model, its paged row, its fixed row: the tp_hybrid phase runs the fixed
# loop on the MoE model only)
TPH_ROWS = (("zamba2-1.2b", "1zt", None), ("jamba-tiny-dev", "1jt", "6jt"))


def hybrid_tp_kernels(gen):
    """Both attention kernels' tp shard path at the hybrids' heads
    (zamba2-1.2b MHA 16/16 of hd 128, jamba-tiny-dev 16/8 of hd 64), the
    ``tp_hybrid`` phase's: every shard of tp 2 and 4 against the plain
    versions (``attend_cases.tp_paged_checks``, and ``tp_fixed_checks``
    where the phase runs the fixed loop), then shard 0 of tp = 2 timed
    (rows 1zt, 1jt, 6jt)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attend_cases as AC

    for name, paged_tag, fixed_tag in TPH_ROWS:
        cfg = get_config(name)
        g = attend_geom(cfg)
        t0 = time.perf_counter()
        err, n = AC.tp_paged_checks(gen, g.h, g.hd, g.w, g.kw)
        msg = f"decode_attend_paged {n} calls"
        if fixed_tag:
            err_f, n_f = AC.tp_fixed_checks(gen, g.h, g.hd, g.w, g.kw)
            msg += (f" and decode_attend {n_f} calls (both launch forms)")
            err = max(err, err_f)
        log("kernels", f"tp shard path at {name}'s heads (H={g.h}/{g.hkv}, "
                       f"hd={g.hd}, W={g.w}), every shard of tp 2 and 4: "
                       f"{msg} within 1e-4 of the plain versions, each "
                       f"launched twice bit for bit; max |err| {err:.3e} "
                       f"({time.perf_counter() - t0:.1f}s)")
        tp_paged_row(cfg, gen, "kernels", paged_tag)
        if fixed_tag:
            tp_fixed_row(cfg, gen, "kernels", fixed_tag)


TP_SHARD = (2, 0)          # the timed shard: rank 0 of tp = 2


def tp_attend_kernels(cfg, gen, phase):
    """Both attention kernels' tensor-parallel shard path (``tp``, ``ti``)
    at ``cfg``'s heads: every shard of tp = 2 and 4 against the plain
    versions (``attend_cases.tp_paged_checks`` / ``tp_fixed_checks``:
    lengths 0 .. 3 blk tp + 5, window 5, softcap, escapes on both sides of
    a span boundary and past the capacity, 1 and 64 slots, two launches
    bit for bit), then one tp = 2 shard timed at the main path's shapes
    (the paged kernel on PAGED_LENGTHS, the fixed one on 4 x 1100 tokens,
    device-length launch) beside SDPA on that shard's decompressed rows,
    the plain version and the bound.  Logs rows ``1t`` and ``6t``."""
    from repro_torch.kernels import attend_cases as AC

    g = attend_geom(cfg)
    t0 = time.perf_counter()
    err_p, n_p = AC.tp_paged_checks(gen, g.h, g.hd, g.w, g.kw)
    err_f, n_f = AC.tp_fixed_checks(gen, g.h, g.hd, g.w, g.kw)
    log(phase, f"tp shard path at {cfg.name}'s heads (H={g.h}/{g.hkv}, "
               f"hd={g.hd}, W={g.w}), every shard of tp 2 and 4: "
               f"decode_attend_paged {n_p} calls (lengths "
               f"{AC.tp_lengths(ATTEND_BLK, 2)} at tp 2, 1 slot, 64 "
               f"slots) and decode_attend {n_f} calls (both launch forms) "
               f"within 1e-4 of the plain versions, each launched twice "
               f"bit for bit; max |err| {err_p:.3e} / {err_f:.3e} "
               f"({time.perf_counter() - t0:.1f}s)")

    tp_paged_row(cfg, gen, phase, "1t")
    tp_fixed_row(cfg, gen, phase, "6t")


MLA_TP_ARCH = "deepseek-v2-lite-16b"


def mla_tp_kernels(gen, phase):
    """Both attention kernels' MLA latent path on the tensor-parallel
    shard path at deepseek-v2-lite's geometry (16 heads over one latent
    row of 512 + 64 columns, values its first 512): every shard of tp 2
    and 4 against the plain versions (``attend_cases.tp_paged_checks`` /
    ``tp_fixed_checks``, the cases of ``tp_attend_kernels``), then shard
    0 of tp = 2 timed beside SDPA on the shard's decompressed latent rows
    (rows ``1mt`` and ``6mt``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attend_cases as AC

    cfg = get_config(MLA_TP_ARCH)
    g = attend_geom(cfg)
    t0 = time.perf_counter()
    err_p, n_p = AC.tp_paged_checks(gen, g.h, g.hd, g.w, g.kw)
    err_f, n_f = AC.tp_fixed_checks(gen, g.h, g.hd, g.w, g.kw)
    log(phase, f"MLA x tp at {cfg.name}'s latent (H={g.h}, W={g.w}, lora "
               f"{g.hd_v}), every shard of tp 2 and 4: decode_attend_paged "
               f"{n_p} calls and decode_attend {n_f} calls (both launch "
               f"forms) within 1e-4 of the plain versions, each launched "
               f"twice bit for bit; max |err| {err_p:.3e} / {err_f:.3e} "
               f"({time.perf_counter() - t0:.1f}s)")
    assert max(err_p, err_f) < 1e-4
    tp_paged_row(cfg, gen, phase, "1mt")
    tp_fixed_row(cfg, gen, phase, "6mt")


def tp_fixed_row(cfg, gen, phase, tag, length=1100, host_length=False):
    """decode_attend's shard 0 of tp = 2 timed at ``cfg``'s heads on the
    fixed loop's shapes (4 sequences of ``length`` global tokens, block
    256, k 5, the shard's blocks, device-length launch; with
    ``host_length`` the host-length one, an encoder-decoder's cross
    attention over its static memory) beside SDPA on that shard's
    decompressed rows, the plain version and the bound; within 1e-4 of
    the plain version.  Logs row ``tag`` and returns it (launches
    None)."""
    import torch
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.kernels import decode_attend, ref

    g = attend_geom(cfg)
    tp, ti = TP_SHARD
    blk, k = ATTEND_BLK, ATTEND_K
    kw = dict(k=k, **g.kw, tp=tp, ti=ti)
    # fixed: 4 sequences of ``length`` global tokens, this shard's blocks
    b = 4
    loc_len = ref.local_length(length, tp, ti)
    blocks, ct, ring, q = _fixed_case(gen, b, g.h, g.hkv, g.hd, blk,
                                      loc_len, w=g.w)
    store = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
             None)
    dev_len = length if host_length else torch.tensor(
        length, dtype=torch.int32, device="cuda")
    fargs = (q, *store, ring, dev_len, ref.WINDOW_NONE)
    err = AC.attend_close(decode_attend.decode_attend(*fargs, **kw),
                          ref.decode_attend_plain(*fargs, **kw))
    live = loc_len // blk
    cap = ct.esc_pos.shape[-1]
    nf = b * blk * g.w
    by = (live * (nf * (1 + k / 8) + (1 << k) + 5 * cap)
          + b * (loc_len - live * blk) * g.w * 2 + q.numel() * 2
          + b * g.h * (g.hd_v + 2) * 4)
    row = dict(max_abs_err=err, launches=None, plain_ms=cuda_ms(
        lambda: ref.decode_attend_plain(*fargs, **kw), reps=5),
        **bound_row(by, 2 * (g.hd + g.hd_v) * b * g.h * loc_len),
        **attend_timing(phase, f"decode_attend tp=2 shard 0 ({cfg.name})",
                        lambda: decode_attend.decode_attend(*fargs, **kw),
                        sdpa_fn(q, fixed_rows(blocks, ring, loc_len),
                                g.kw["mla_lora"])))
    log(phase, f"{tag} decode_attend at {cfg.name}'s heads (H={g.h}/"
               f"{g.hkv}, hd={g.hd}, W={g.w}), shard {ti} of tp {tp} (B={b}, "
               f"global length {length}, shard rows {loc_len}, "
               f"{'host' if host_length else 'device'}-length launch): "
               f"{row}")
    return row


def tp_paged_row(cfg, gen, phase, tag):
    """decode_attend_paged's shard 0 of tp = 2 timed at ``cfg``'s heads on
    the main path's shapes (4 slots of PAGED_LENGTHS global tokens, block
    256, k 5, the shard's pages) beside SDPA on that shard's decompressed
    rows, the plain version and the bound; within 1e-4 of the plain
    version.  Logs row ``tag`` and returns it (launches None)."""
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.kernels import decode_attend, ref

    g = attend_geom(cfg)
    tp, ti = TP_SHARD
    blk, k = ATTEND_BLK, ATTEND_K
    kw = dict(k=k, **g.kw, tp=tp, ti=ti)
    loc = [ref.local_length(L, tp, ti) for L in PAGED_LENGTHS]
    n_live = sum(L // blk for L in loc)
    pages = _pages(gen, n_live + 2, blk, g.w)
    ct = fixed.compress_many(pages, k=k)
    q, ring, page_ids, _ = paged_case(gen, g.h, g.hd, n_live + 2, blk, g.w,
                                      loc)
    lens = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")
    fields = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
              None)
    args = (q, *fields, ring, page_ids, lens, ref.WINDOW_NONE)
    err = AC.attend_close(decode_attend.decode_attend_paged(*args, **kw),
                          ref.paged_decode_attend_plain(*args, **kw))
    s_, n = len(loc), blk * g.w
    c = ct.esc_pos.shape[-1]
    lib_fn = sdpa_fn(q, torch.cat([fixed.decompress(ct)[page_ids.long()]
                                   .reshape(s_, -1, g.w), ring], 1),
                     g.kw["mla_lora"])
    by = (n_live * (n * (1 + k / 8) + c) + sum(L % blk for L in loc) * g.w
          * 2 + q.numel() * 2 + s_ * g.h * (g.hd_v + 2) * 4)
    row = dict(max_abs_err=err, launches=None, plain_ms=cuda_ms(
        lambda: ref.paged_decode_attend_plain(*args, **kw), reps=5),
        **bound_row(by, 2 * (g.hd + g.hd_v) * g.h * sum(loc)),
        **attend_timing(phase, f"decode_attend_paged tp=2 shard 0 "
                               f"({cfg.name})",
                        lambda: decode_attend.decode_attend_paged(
                            *args, **kw), lib_fn))
    log(phase, f"{tag} decode_attend_paged at {cfg.name}'s heads (H="
               f"{g.h}/{g.hkv}, hd={g.hd}, W={g.w}), shard {ti} of tp {tp} "
               f"(S={s_}, global lengths {PAGED_LENGTHS}, shard rows {loc}, "
               f"{n_live} live pages): {row}")
    return row


ATTEND_BLK, ATTEND_K = 256, 5
PAGED_LENGTHS = [300, 700, 1100, 2000]


def bound_row(by: float, flops: float) -> dict:
    """The JSON line's bound of an attention kernel's work: ``by`` bytes
    moved, ``flops`` operations on bf16 operands (q and the decoded rows;
    the MLA query is rounded to bf16 before the kernel) with f32
    accumulation, at the card's bf16 tensor-core rate."""
    t_bytes, t_ops = by / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def paged_attend_kernel(cfg, gen, phase, small=False):
    """decode_attend_paged against its plain version at ``cfg``'s attention
    shapes (block 256, k 5, slots of PAGED_LENGTHS walking permuted pool
    pages, the escape and overflow pages live in the longest slot): the
    codec pair exact on the pool's pages and the card's compress equal to
    the CPU's; within 1e-4 at full and window 700, codec off, with two
    slots aliased and at the split edges; two launches bit for bit; timed
    beside SDPA and its bound; every call at the config's attention
    softcap (``small``: the escape and overflow pages of bounded values,
    see ``_pages``).  Returns (the JSON row, the pool's pages as rows, the
    escape capacity)."""
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.kernels import decode_attend, lexi_unpack, ops, ref
    from repro_torch.models import cache as cache_mod

    blk, k, lengths = ATTEND_BLK, ATTEND_K, PAGED_LENGTHS
    g = attend_geom(cfg)
    hd, hkv, h, w = g.hd, g.hkv, g.h, g.w
    n = blk * w
    c = max(n // 128, 8)
    s_ = len(lengths)
    n_live = sum(L // blk for L in lengths)
    n_pages = n_live + 2
    pages = _pages(gen, n_pages, blk, w, small)
    rows = pages.reshape(n_pages, n)
    how = codec_check(f"{cfg.name} pool pages", rows, k)

    # the kernel-backed codec equals the CPU codec byte for byte
    ct = fixed.compress_many(pages, k=k, esc_capacity=c)
    ct_cpu = fixed.compress_many(pages.cpu(), k=k, esc_capacity=c)
    for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
              "n_escapes"):
        assert torch.equal(getattr(ct, f).cpu(), getattr(ct_cpu, f)), f
    n_esc = ct.n_escapes.cpu().tolist()
    assert n_esc[1] > 0 and n_esc[1] <= c and n_esc[2] > c, n_esc
    # lexi_unpack on the pool pages, and the kernel-backed decompress
    i16 = lambda t: t.view(torch.int16)
    fl = (ct.signman, ct.planes, ct.dict_syms)
    assert torch.equal(i16(lexi_unpack.lexi_unpack(*fl, ct.k)),
                       i16(ref.unpack_ref(*fl, ct.k)))
    assert torch.equal(i16(ops.unpack(ct)), i16(fixed.decompress(ct)))
    log(phase, f"exp_histogram and lexi_pack on {cfg.name}'s {n_pages} pool "
               f"pages ({blk} x {w}) exact ({how}); compress on the card == "
               f"compress on the CPU (escapes per page {n_esc[:4]}..., "
               f"capacity {c}); lexi_unpack on them == plain, ops.unpack == "
               f"fixed.decompress bit for bit")

    # decode_attend_paged: slots walk permuted pages; the escape and
    # overflow pages are live in the longest slot
    q, ring, page_ids, lens = paged_case(gen, h, hd, n_pages, blk, w,
                                         lengths)
    maxp = page_ids.shape[1]
    fields = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
              None)
    kw = dict(k=k, softcap=cfg.attn_softcap, **g.kw)
    if cfg.mla is None:
        assert g.kw["kv_idx"] == cache_mod.gqa_head_table(cfg, h)
    errs = []
    for window in (ref.WINDOW_NONE, 700):
        args = (q, *fields, ring, page_ids, lens, window)
        errs.append(AC.attend_close(
            decode_attend.decode_attend_paged(*args, **kw),
            ref.paged_decode_attend_plain(*args, **kw)))
    # codec off: raw bf16 pages through the same kernel
    raw = (None,) * 5 + (fixed.decompress(ct),)
    args_raw = (q, *raw, ring, page_ids, lens, ref.WINDOW_NONE)
    errs.append(AC.attend_close(
        decode_attend.decode_attend_paged(*args_raw, **kw),
        ref.paged_decode_attend_plain(*args_raw, **kw)))
    # prefix sharing: slot 1 holds the longest slot's page-table row (its
    # escape and overflow pages), q, ring and length, as after a hit
    q_a, ring_a, ids_a, lens_a = AC.alias_slot(q, ring, page_ids, lens,
                                               src=s_ - 1, dst=1)
    args_a = (q_a, *fields, ring_a, ids_a, lens_a, ref.WINDOW_NONE)
    got = decode_attend.decode_attend_paged(*args_a, **kw)
    errs.append(AC.attend_close(got, ref.paged_decode_attend_plain(
        *args_a, **kw)))
    assert AC.same_bits([t[1] for t in got], [t[s_ - 1] for t in got]), \
        "decode_attend_paged: aliased slots differ"
    log(phase, f"decode_attend_paged, slots 1 and {s_ - 1} on the same "
               f"page ids, q, ring and length {int(lens_a[1])}: within "
               f"1e-4 of the plain version (max {errs[-1]:.3g}), the "
               f"two slots' (out, m, l) equal bit for bit")

    args = (q, *fields, ring, page_ids, lens, ref.WINDOW_NONE)
    first = decode_attend.decode_attend_paged(*args, **kw)
    assert AC.same_bits(first, decode_attend.decode_attend_paged(*args, **kw)), \
        "decode_attend_paged: two launches differ"
    grid_line(phase, "decode_attend_paged", h, hkv, hd, blk, s_,
              decode_attend.paged_splits(maxp, blk), k, g.kw["mla_lora"])
    errs.append(split_edges_paged(cfg, gen, phase))
    # yardstick: one library call (SDPA, GQA) on already-decompressed
    # pages gathered per slot; the port never calls it
    lib_fn = sdpa_fn(q, torch.cat(
        [raw[-1][page_ids.long()].reshape(s_, -1, w), ring], 1),
        g.kw["mla_lora"])
    ring_rows = sum(L % blk for L in lengths)
    page_bytes = n * (1 + k / 8) + c
    by = (n_live * page_bytes + ring_rows * w * 2 + q.numel() * 2
          + s_ * h * (g.hd_v + 2) * 4)
    row = dict(
        max_abs_err=max(errs),
        plain_ms=cuda_ms(lambda: ref.paged_decode_attend_plain(*args, **kw),
                         reps=5),
        # each slot's heads score and weigh its own positions: 2 (hd +
        # hd_v) f32 operations per (head, position)
        **bound_row(by, 2 * (hd + g.hd_v) * h * sum(lengths)),
        **attend_timing(phase, "decode_attend_paged",
                        lambda: decode_attend.decode_attend_paged(*args, **kw),
                        lib_fn))
    log(phase, f"decode_attend_paged (S={s_}, H={h}/{hkv}, hd={hd}, "
               f"W={w}, hd_v={g.hd_v}, "
               f"lengths {lengths}, {n_live} live pages) within 1e-4 "
               f"(full + window 700 + codec off + split edges), two "
               f"launches bit for bit: {row}")
    return row, rows, c


def grid_line(phase, name, h, hkv, hd, blk, n_seq, nsplit, k,
              mla_lora=None):
    """Log a kernel's launch: grid, threads, chunk rows, shared memory per
    CTA, and registers and spills of its k instantiation (ptxas -v)."""
    from repro_torch.kernels import decode_attend
    span = decode_attend.span_rows(blk)
    geo = decode_attend.geometry(hd, h - (hkv - 1) * (h // hkv), span,
                                 mla_lora)
    regs = next((r for (_, args), r in ptxas_report(name).items()
                 if args == (k,)), {})
    log(phase, f"{name} launch at H={h}/{hkv}, hd={hd}: nsplit {nsplit} "
               f"(P={span} rows), grid {hkv} x {n_seq} x {nsplit} = "
               f"{hkv * n_seq * nsplit} CTAs of {geo['threads']} "
               f"threads, chunks of {geo['chunk_rows']} rows, "
               f"{geo['smem_bytes']} B shared memory per CTA, "
               f"{regs.get('registers')} registers, spills "
               f"{regs.get('spill_stores')}/{regs.get('spill_loads')} B "
               f"(k={k})")


def split_edges_paged(cfg, gen, phase):
    """The paged kernel's split edge cases at ``cfg``'s heads, block 256
    (P = 128): slot lengths at span and block edges, a window leaving only
    the last span, a page with escapes on rows P - 1 and P and one past
    its capacity; then 1 and 64 slots.  Every call within 1e-4 and
    bit-identical on a second launch."""
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.kernels import decode_attend, ref

    blk, k = 256, 5
    g = attend_geom(cfg)
    h, hd, w = g.h, g.hd, g.w
    p = decode_attend.span_rows(blk)
    kw = dict(k=k, **g.kw)
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
    log(phase, f"decode_attend_paged split edges (P={p}, block {blk}): "
               f"lengths {AC.edge_lengths(blk)}, 1 slot, 64 slots; full, "
               f"window 700, window 5 (last span only), softcap 50; "
               f"escapes on rows {p - 1} and {p} of a page and past the "
               f"capacity of another: {n_calls} calls within 1e-4, each "
               f"launched twice bit for bit; max |err| {worst:.3e}")
    return worst


def split_edges_fixed(cfg, gen, phase):
    """The fixed kernel's split edge cases at ``cfg``'s heads, block 256,
    3 sequences: the lengths of ``attend_cases.edge_lengths``, full / window 5 /
    window 700 / softcap; block 1 holds escapes in sequence 0 and, in
    sequence 2, on rows P - 1 and P (within the capacity) followed by more
    than the capacity holds.  Within 1e-4, bit-identical twice."""
    import torch
    from repro_torch.core import fixed
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.kernels import decode_attend, ref

    blk, k, b = 256, 5, 3
    g = attend_geom(cfg)
    h, hd, w = g.h, g.hd, g.w
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
    kw = dict(k=k, **g.kw)
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
    log(phase, f"decode_attend split edges (P={p}, block {blk}, B={b}): "
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


def _fixed_case(gen, b, h, hkv, hd, blk, length, k=5, w=None):
    """The kernel's arguments at one attention shape (rows of ``w``
    columns, 2 * hkv * hd by default): a store of length // blk + 1
    blocks (the last one dead), its ring and q."""
    import torch
    from repro_torch.core import fixed

    w = 2 * hkv * hd if w is None else w
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


# arch: (length, window); seamless's length is the memory's in the
# families phase (512 encoder frames), its decoder layers windowless
FIXED_CASES = {"gemma2-9b": (4400, 4096), "seamless-m4t-large-v2": (512, 200)}


def fixed_attend_kernel(cfg, gen, phase, also=(), host_length=False):
    """decode_attend against its plain version at ``cfg``'s attention
    shapes and at those of the archs in ``also`` (B=4, block 256, length
    1100 and window 700 unless FIXED_CASES says otherwise): full, window,
    softcap 50, codec off, host- and device-length launches; at ``cfg``'s
    the split edges too, two launches bit for bit, timed beside SDPA and
    its bound (the device-length launch, the decode loop's form; with
    ``host_length`` the host-length one, the form of an encoder-decoder's
    cross attention, whose length is static).  Returns the JSON row."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import attend_cases as AC
    from repro_torch.kernels import decode_attend, ref

    b, blk, k, softcap = 4, ATTEND_BLK, ATTEND_K, 50.0
    errs = []
    for c_ in (cfg, *map(get_config, also)):
        length, window = FIXED_CASES.get(c_.name, (1100, 700))
        g = attend_geom(c_)
        h, hkv, hd = g.h, g.hkv, g.hd
        blocks, ct, ring, q = _fixed_case(gen, b, h, hkv, hd, blk, length,
                                          w=g.w)
        cap = ct.esc_pos.shape[-1]
        n_esc = ct.n_escapes.tolist()
        assert n_esc[1] > cap, n_esc                          # overflow
        assert bool((ct.esc_pos[1] < blk * g.w).any())
        kw = dict(k=k, softcap=c_.attn_softcap, **g.kw)
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
        log(phase, f"decode_attend at {c_.name}'s shapes (B={b}, H={h}/"
                   f"{hkv}, hd={hd}, W={g.w}, hd_v={g.hd_v}, block {blk}, "
                   f"length {length}, "
                   f"{length // blk} live blocks, escapes per block "
                   f"{n_esc[:3]}..., capacity {cap}) within 1e-4: full, "
                   f"window {window}, softcap {softcap}, codec off; "
                   f"host-length and device-length launches; "
                   f"max |err| {errs[-1]:.3e}")
        if c_ is not cfg:
            del blocks, ct, ring, q, store, args, args_raw
            torch.cuda.empty_cache()
            continue
        # timed: the device-length launch, as the decode loop runs it
        # (its grid the store's capacity: length // blk + 1 blocks and the
        # ring); the host-length launch logged beside it
        host_form = (args + (full,), kw)
        dev_len = torch.tensor(length, dtype=torch.int32, device="cuda")
        timed = ((q, *store, ring, dev_len, full), kw)
        if host_length:
            host_form, timed = timed, host_form
        for form in (host_form, timed):
            first = decode_attend.decode_attend(*form[0], **form[1])
            assert AC.same_bits(first, decode_attend.decode_attend(
                *form[0], **form[1])), "decode_attend: two launches differ"
        nblk = store[0].shape[0]
        grid_line(phase, "decode_attend", h, hkv, hd, blk, b,
                  decode_attend.fixed_splits(length, full, blk)[1], k,
                  g.kw["mla_lora"])
        grid_line(phase, "decode_attend", h, hkv, hd, blk, b,
                  decode_attend.capacity_splits(nblk, blk), k,
                  g.kw["mla_lora"])

        def host_fn():
            return decode_attend.decode_attend(*host_form[0], **host_form[1])

        log(phase, f"decode_attend {'device' if host_length else 'host'}"
                   f"-length launch (the one not in the row): "
                   f"{cuda_ms(host_fn):.4f} ms with the "
                   f"spin, host time per call {host_us(host_fn):.1f} us")
        errs.append(split_edges_fixed(cfg, gen, phase))
        live = length // blk
        lib_fn = sdpa_fn(q, fixed_rows(blocks, ring, length),
                         g.kw["mla_lora"])
        n = b * blk * g.w
        by = (live * (n * (1 + k / 8) + (1 << k) + 5 * cap)
              + b * (length - live * blk) * g.w * 2
              + q.numel() * 2 + b * h * (g.hd_v + 2) * 4)
        row = dict(
            max_abs_err=None,
            plain_ms=cuda_ms(lambda: ref.decode_attend_plain(
                *timed[0], **timed[1]), reps=5),
            **bound_row(by, 2 * (hd + g.hd_v) * b * h * length),
            **attend_timing(phase, "decode_attend", lambda: decode_attend
                            .decode_attend(*timed[0], **timed[1]), lib_fn))
    row["max_abs_err"] = max(errs)
    log(phase, f"decode_attend at {cfg.name}'s shapes, full window, "
               f"codec on, {'host' if host_length else 'device'}-length "
               f"launch: {row}")
    return row


SSM_MATMULS = ("w_zx", "w_bc", "w_dt", "w_out")
# packed leaves the port reads whole through ``layers.raw_weight`` (one
# lexi_unpack launch a leaf, or a layer's slice of it), never through
# decompress_matmul; a MoE layer's expert stacks are read so too
RAW_READ = ("conv_x", "conv_bc", "w_uk", "w_uv")
EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def weight_shapes(cfg, tp: int = 1):
    """[((K, N), matmuls per decode step)] of the model's packed weights
    that go through decompress_matmul, on one rank of ``tp``: the
    attention projections per layer (wq, wk and wv, wo; MLA's wq, w_dkv,
    wo, w_dkv row-parallel at tp > 1), the dense FFN's w_gate and w_up,
    w_down or a MoE layer's router and shared experts, a hybrid's SSM
    projections (SSM_MATMULS), and the LM head.  At tp > 1 a column-parallel leaf keeps N / tp columns and a
    row-parallel one K / tp rows: wq (over the query heads padded for tp),
    wk and wv in the ``col`` kv mode (K / tp in the ``row`` mode), w_gate,
    w_up, the shared experts' ws_gate and ws_up, the SSM's w_zx and w_dt
    and the LM head (over the vocabulary padded for tp) are
    column-parallel, wo, w_down, ws_down and the SSM's w_bc and w_out
    row-parallel; the router is replicated.  Leaves that
    stay raw (the whole leaf too small, or the rank's N not a multiple of
    32) are left out."""
    from repro_torch.core import weights
    from repro_torch.models import ssm as ssm_mod
    d, hd, layers = cfg.d_model, cfg.head_dim, cfg.n_layers
    col, row = (1, tp), (tp, 1)            # (K, N) divisors
    if cfg.mla is None:
        q, kv = cfg.padded_heads(tp) * hd, cfg.n_kv_heads * hd
        kv_split = col if cfg.n_kv_heads % tp == 0 else row
        shapes = [((d, q), layers, col), ((d, kv), 2 * layers, kv_split),
                  ((q, d), layers, row)]
    else:                   # w_dkv row-parallel at tp > 1, as wo
        m, hq = cfg.mla, cfg.padded_heads(tp)
        shapes = [((d, hq * (m.qk_nope_dim + m.qk_rope_dim)), layers, col),
                  ((d, m.kv_lora_rank + m.qk_rope_dim), layers, row),
                  ((hq * m.v_dim, d), layers, row)]
    f = cfg.d_ff
    if cfg.moe is not None:             # the router is replicated
        shapes.append(((d, cfg.moe.n_experts), layers, (1, 1)))
        f = cfg.moe.n_shared * cfg.moe.d_ff
    if f:
        shapes += [((d, f), 2 * layers, col), ((f, d), layers, row)]
    if cfg.ssm is not None:
        table = ssm_mod.ssm_table(cfg, tp)
        for name in SSM_MATMULS:
            sp = table[name].spec
            shapes.append((table[name].shape, layers,
                           tuple(tp if a == "model" else 1 for a in sp)))
    if not cfg.tie_embeddings:          # a tied head is the raw embedding
        shapes.append(((d, cfg.padded_vocab(tp)), 1, col))
    return [((kk // dk, n // dn), c) for (kk, n), c, (dk, dn) in shapes
            if kk * n >= weights.MIN_COMPRESS_SIZE
            and (n // dn) % weights.LANES == 0]


def weight_case(w, pw, gen):
    """Both weight kernels on one (K, N) leaf ``w`` and its packed form
    ``pw``: decompress_matmul at M 4 and 1024 within 1e-4 * (|x| @ |W|) +
    1e-6 of its plain version, two launches bit for bit; lexi_unpack equal
    to ``w`` and to its plain version.  Returns {M: (x, max |err|)}."""
    import torch
    from repro_torch.kernels import decompress_matmul, lexi_unpack, ref

    kk = w.shape[0]
    fields = (pw.signman, pw.planes, pw.dict_syms)
    cases = {}
    for m in (4, 1024):
        x = torch.randn((m, kk), generator=gen, device="cuda").to(
            torch.bfloat16)
        got = decompress_matmul.decompress_matmul(x, *fields, pw.k)
        again = decompress_matmul.decompress_matmul(x, *fields, pw.k)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
            (tuple(w.shape), m)
        want = ref.decompress_matmul_ref(x, *fields, pw.k)
        tol = 1e-4 * (x.float().abs() @ w.float().abs()) + 1e-6
        err = (got - want).abs()
        assert bool((err <= tol).all()), (tuple(w.shape), m,
                                          float(err.max()))
        cases[m] = (x, float(err.max()))
        del got, again, want, tol, err
    rows = (pw.signman.reshape(1, -1), pw.planes.reshape(1, pw.k, -1),
            pw.dict_syms.reshape(1, -1))
    got = lexi_unpack.lexi_unpack(*rows, pw.k).view(torch.int16)
    assert torch.equal(got, w.reshape(1, -1).view(torch.int16))
    assert torch.equal(got, ref.unpack_ref(*rows, pw.k).view(torch.int16))
    return cases


def stacked_unpack_check(w, pw):
    """lexi_unpack on a stacked packed leaf (L, K, N) in one launch: the
    leaf's bits, and the plain version's row by row (its int64
    temporaries)."""
    import torch
    from repro_torch.core import weights
    from repro_torch.kernels import ref

    i16 = lambda t: t.view(torch.int16)
    back = weights.unpack_weight(pw)
    assert torch.equal(i16(back), i16(w))
    for i in range(w.shape[0]):
        row = ref.unpack_ref(pw.signman[i].reshape(1, -1),
                             pw.planes[i].reshape(1, pw.k, -1),
                             pw.dict_syms[i].reshape(1, -1), pw.k)
        assert torch.equal(i16(row), i16(back[i].reshape(1, -1)))


def weight_kernels(cfg, gen):
    """lexi_unpack and decompress_matmul against their plain versions at
    ``cfg``'s weight shapes, timed."""
    import torch
    from repro_torch.core import weights
    from repro_torch.kernels import decompress_matmul, lexi_unpack, ref

    bf16 = torch.bfloat16
    # one stacked leaf packed on the card
    nl, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    w = (torch.randn((nl, d, f), generator=gen, device="cuda") * 0.02
         ).to(bf16)
    pw = weights.pack_serving_params({"blocks": {"w": w}},
                                     backend="cuda")["blocks"]["w"]
    assert isinstance(pw, weights.PackedWeight), "stacked leaf not packed"
    stacked_unpack_check(w, pw)
    log("kernels", f"lexi_unpack on a packed stacked leaf {tuple(w.shape)} "
                   f"(k={pw.k}, one launch of {nl} rows): exact, and equal "
                   f"to the plain version row by row")
    del w, pw

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
        for m, (x, err) in weight_case(w, pw, gen).items():
            fn = lambda: decompress_matmul.decompress_matmul(x, *fields, pw.k)
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
                           f"|err| {err:.3e} within "
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
                dm["max_abs_err"] = max(dm["max_abs_err"], err)
        rows = (pw.signman.reshape(1, -1), pw.planes.reshape(1, pw.k, -1),
                pw.dict_syms.reshape(1, -1))
        fn = lambda: lexi_unpack.lexi_unpack(*rows, pw.k)
        t = cuda_ms(fn)
        t_plain = cuda_ms(lambda: ref.unpack_ref(*rows, pw.k), reps=3)
        t_host = host_us(fn)
        t_bound = (pw.nbytes() + 2 * kk * n) / HBM_BYTES_PER_S * 1e3
        log("kernels", f"lexi_unpack K={kk} N={n} k={pw.k}: exact (the leaf's "
                       f"bits and the plain version's); {t:.4f} "
                       f"ms, plain {t_plain:.4f} ms, bound {t_bound:.5f} ms; "
                       f"host {t_host:.1f} us per call")
        un["ms"] += count * t
        un["plain_ms"] += count * t_plain
        un["bound_ms"] += count * t_bound
        un["host_us"] += count * t_host
        packed.append((pw, count))
        del w, x, fields, rows
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


def small_model_diff(packed: bool, cfg=None, tg=None) -> float:
    """Prefill + 10 teacher-forced paged decode steps of a tiny model (a
    dense one by default) on the card and on the CPU from the same weights
    and tokens; returns the largest logit gap (<= 1e-2).  With ``tg`` (a
    rank of a gloo group) both run at tp = world from the rank's shard of
    the weights (a 10-token prompt; the whole-vocab logits compared)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ModelConfig, RunConfig
    from repro_torch.core import collectives as cl, weights
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.models import lm, params as PM
    from repro_torch.serve import engine

    if cfg is None:
        cfg = ModelConfig(name="tiny", family="dense", n_layers=2,
                          d_model=64, n_heads=8, n_kv_heads=4, d_ff=128,
                          vocab_size=512, head_dim=16, qk_norm=True)
    tp = cl.world(tg)
    run = RunConfig(codec=CodecConfig(cache_block=4))
    params = PM.init_params(lm.lm_table(cfg),
                            torch.Generator().manual_seed(3))
    table = lm.lm_table(cfg, tp)
    if tp > 1:
        params = PM.shard_params(PM.pad_for_tp(params, cfg, tp), table, tp,
                                 tg.rank)
    if packed:                    # CPU: torch backend; on the card: cuda
        params = weights.pack_serving_params(params, table=table, tg=tg)
        assert any(isinstance(leaf, weights.PackedWeight)
                   for leaf in weights.leaves(params["blocks"]))
    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (2, 9 if tp == 1 else 10)),
                             dtype=torch.int32)
    worst = 0.0
    states, toks = {}, {}

    def whole(lg):
        return cl.all_gather(lg, tg, axis=-1).float().cpu()

    for dev in ("cpu", "cuda"):
        p = PM.to_device(params, dev)
        st = engine.empty_paged_state(cfg, run, 2, 64, device=dev, tp=tp)
        logits, d = engine.prefill_sequences(cfg, run, p, prompt.to(dev),
                                             tg)
        engine.insert_sequences(cfg, run, st, d, [0, 1], tp)
        states[dev], toks[dev] = (st, p), [whole(logits)]
    feed = engine.greedy_token(toks["cpu"][0])
    for _ in range(10):                     # crosses two page flushes
        for dev in ("cpu", "cuda"):
            st, p = states[dev]
            toks[dev].append(whole(engine.paged_decode_step(
                cfg, run, p, st, feed.to(dev), tg)))
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

    def release(self, pkv, slots_mask, free_mask=None):
        for slot in range(len(slots_mask)):
            if slots_mask[slot]:
                self.rows.pop(slot, None)
        self._release(pkv, slots_mask, free_mask)

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
                      device="cuda", cuda_graphs=False, prefix_sharing=False)
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

    def keep(i, kv, _ssm):
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
    bit for bit, and its timing beside the eager run's (the serve
    phase's: its flush check syncs the host once a step, which moved its
    tok/s by under 2% against a run without it); then the 4 slots' decode
    profiled both ways, and one flushing step timed on its own.  Returns
    the graph run's launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import ServeEngine, format_stats

    run, reqs, eager = served["run"], served["reqs"], served["stats"]
    eng = ServeEngine(cfg, run, n_slots=4, max_len=8 * 256,
                      params=serve_eng.params, device="cuda",
                      cuda_graphs=True, prefix_sharing=False)
    ops.reset_launch_counts()
    results, st = eng.run(reqs)
    torch.cuda.synchronize()
    assert [r.tokens for r in results] == served["streams"]
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
    for graphs, st in ((False, eager), (True, st)):
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
    graph_launches = fixed_graphs(cfg, run, params, prompts, max_len, n,
                                  smi)[0]

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
                      device="cuda", prefix_sharing=False)
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


def fixed_graphs(cfg, run, params, prompts, max_len, n, smi, extras=None,
                 phase="graphs"):
    """The fixed loop (``engine.FixedDecoder``, as ``generate`` runs it)
    eagerly and from a CUDA graph: the same tokens, and every layer's
    block store and ring byte-identical (an encoder-decoder's
    cross-attention stores and a hybrid's or an SSM model's state too);
    the ring flushes the only eager steps of the graph run (none for an
    attention-free model).  ``extras``: the stub inputs
    (``front_embeds``, ``enc_embeds``).  Returns (the graph run's
    launches of ``decode_attend``, its state, its ms per step without
    the capture)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import engine

    b, s = prompts.shape
    blk = run.codec.cache_block
    runs = {}
    for graphs in (False, True):
        logits, st = engine.prefill(cfg, run, params, prompts, max_len,
                                    **(extras or {}))
        dec = engine.FixedDecoder(cfg, run, params, st,
                                  engine.greedy_token(logits), graphs)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [dec.tok.clone()]
        for i in range(n):
            if i == 1:             # the first step captures
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            dec.step()
            out.append(dec.tok.clone())
        toks = torch.cat(out, 1).cpu()
        wall = time.perf_counter() - t0
        step_ms = (time.perf_counter() - t1) * 1e3 / (n - 1)
        runs[graphs] = (toks, st, dec.counts, ops.launch_counts(), wall,
                        step_ms)
    (t_e, st_e, c_e, _, w_e, _), (t_g, st_g, c_g, launches, w_g, ms_g) = \
        runs[False], runs[True]
    assert torch.equal(t_e, t_g), "fixed loop: graph tokens != eager"
    assert int(st_g.length_dev) == st_g.length == st_e.length == s + n
    n_bytes = 0
    for kv_e, kv_g in zip((st_e.kv or []) + (st_e.xkv or []),
                          (st_g.kv or []) + (st_g.xkv or [])):
        for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
                  "ring"):
            a, g = getattr(kv_e, f), getattr(kv_g, f)
            assert torch.equal(a.view(torch.uint8), g.view(torch.uint8)), f
            n_bytes += a.numel() * a.element_size()
    if st_e.ssm is not None:          # the recurrent state too
        n_bytes += same_ssm(st_e.ssm, st_g.ssm)
    flushes = 0 if st_e.kv is None else sum(
        (s + t) % blk == blk - 1 for t in range(n))
    assert c_e.eager == n and c_g.eager == c_g.flush == flushes, c_g
    assert c_g.replays == n - flushes and c_g.captures == 1
    passes = c_g.eager + c_g.replays + c_g.captures
    stores = (st_e.kv is not None) + (st_e.xkv is not None)
    assert launches["decode_attend"] == stores * cfg.n_layers * passes, \
        launches
    extra = [name for name, on in (("cross-attention stores",
                                    st_e.xkv is not None),
                                   ("SSM state", st_e.ssm is not None)) if on]
    log(phase, f"fixed loop ({cfg.name}), {b} x ({s} prompt + {n} "
               f"steps), from a CUDA graph: tokens and all {n_bytes} B "
               f"of block stores and rings{''.join(', ' + e for e in extra)}"
               f" equal to the eager loop's; {c_g.eager} eager step(s) "
               f"(ring flushes), {c_g.replays} replayed, 1 capture; "
               f"decode_attend {launches['decode_attend']} launches = "
               f"{stores} x {cfg.n_layers} x {passes}; {n} steps in "
               f"{w_e * 1e3:.1f} ms eager, {w_g * 1e3:.1f} ms from the "
               f"graph (the capture included; {ms_g:.3f} ms a step after "
               f"it) | {smi}")
    del runs
    return launches["decode_attend"], st_g, ms_g


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
    # the stacked leaf's first 4 layers (each slice has its own
    # dictionary; a CPU pack of all 36 takes ≈ 50 s on the card's host)
    for path, n in ((("blocks", "mlp", "w_gate"), 4), (("lm_head",), None)):
        t0 = time.perf_counter()
        cpu = _at(weights.pack_serving_params(
            _nest(path, _at(params, path)[:n].cpu())), path)
        card = _at(packed, path)
        card = card if n is None else card[:n]
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
                          cuda_graphs=name != "cuda_eager",
                          prefix_sharing=False)
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


# ---------------------------------------------------------------------------
# phase 9: prefix sharing and the tiered PageCache
# ---------------------------------------------------------------------------

PREFIX_BLK, PREFIX_MAX_LEN = 256, 4096


def prefix_mix(cfg, rng):
    """The prefix phase's requests and {duplicate uid: original uid}.
    Four system prompts of 2048 tokens (8 page columns each) cycle A B C
    D over 3 rounds, each followed by a distinct seeded user tail of
    64-448 tokens, budgets 16-32.  Between rounds 2 and 3 come 6 unrelated
    2048-token prompts (budget 16): the 12 requests alone hold at most 44
    distinct columns of the pool's 72, and these 48 more make retention
    press on the pool, so that columns are evicted and restored from the
    warm tier within the run.  Last, exact duplicates of two earlier
    prompts: one whose tail fits one column and one whose tail crosses
    into a second."""
    import numpy as np
    from repro_torch.serve.scheduler import Request

    v = cfg.vocab_size
    systems = [rng.integers(0, v, (2048,)) for _ in range(4)]
    tails = rng.choice(np.arange(64, 449), 12, replace=False)
    reqs, tail_of = [], {}

    def add(prompt, budget):
        reqs.append(Request(uid=len(reqs), prompt=prompt.astype(np.int32),
                            max_new_tokens=int(budget)))

    for rnd in range(3):
        if rnd == 2:
            for _ in range(6):
                add(rng.integers(0, v, (2048,)), 16)
        for j in range(4):
            t = int(tails[4 * rnd + j])
            tail_of[len(reqs)] = t
            add(np.concatenate([systems[j], rng.integers(0, v, (t,))]),
                rng.integers(16, 33))
    short = min(u for u, t in tail_of.items() if t <= PREFIX_BLK)
    long_ = min(u for u, t in tail_of.items() if t > PREFIX_BLK)
    dups = {}
    for orig in (short, long_):
        dups[len(reqs)] = orig
        add(reqs[orig].prompt.copy(), reqs[orig].max_new_tokens)
    return reqs, dups


class SharingProbe:
    """Watches one ServeEngine with prefix sharing: the time and columns
    of every spill (the card-to-host export and the digests) and of every
    admission by a hit (map, then the warm wire built and imported), each
    from a synchronised card to a synchronised card; each hit's keys, its
    hot and warm columns and the slot's page-table row after it; and the
    tokens of every batched prefill (for the teacher-forced check)."""

    def __init__(self, eng):
        import numpy as np
        import torch
        self.eng, self.sync = eng, torch.cuda.synchronize
        self.spill_s, self.spill_cols = 0.0, 0
        self.import_s, self.import_cols, self.hits = 0.0, 0, []
        self.batches = {}             # uid -> (batch tokens, row)
        spill, admit, cold = (eng._spill_slots, eng._admit_shared,
                              eng._admit_cold_batch)

        def spill_slots(slots, rows):
            n0 = len(eng.cache.warm)
            self.sync()
            t0 = time.perf_counter()
            spill(slots, rows)
            self.sync()
            self.spill_s += time.perf_counter() - t0
            self.spill_cols += len(eng.cache.warm) - n0

        def admit_shared(ls, s, req, m, keys, warm):
            self.sync()
            t0 = time.perf_counter()
            admit(ls, s, req, m, keys, warm)
            self.sync()
            if warm:
                self.import_s += time.perf_counter() - t0
                self.import_cols += len(warm)
            self.hits.append(dict(uid=req.uid, keys=list(keys), m=m,
                                  h=m - len(warm),
                                  row=eng.state.kv.page_table[s].copy()))

        def admit_cold(ls, batch, slots, trunk, replays):
            toks = torch.as_tensor(np.stack([r.prompt[:trunk]
                                             for r in batch]),
                                   dtype=torch.int32, device=eng.device)
            for j, r in enumerate(batch):
                self.batches[r.uid] = (toks, j)
            cold(ls, batch, slots, trunk, replays)

        eng._spill_slots = spill_slots
        eng._admit_shared = admit_shared
        eng._admit_cold_batch = admit_cold

    def line(self):
        sp = self.spill_s * 1e3 / max(self.spill_cols, 1)
        im = self.import_s * 1e3 / max(self.import_cols, 1)
        return (f"spill {self.spill_cols} columns in {self.spill_s * 1e3:.1f}"
                f" ms ({sp:.2f} ms per column), warm import "
                f"{self.import_cols} columns in {self.import_s * 1e3:.1f} ms "
                f"({im:.2f} ms per column, the map included)")


def pool_page_payloads(pkv, page: int, codec_on: bool):
    """One pool page's payload per layer, in the transport's wire bytes."""
    from repro_torch.models import cache as cache_mod
    from repro_torch.serve import scheduler, transport
    wire = cache_mod.PageWire(
        *(None if getattr(pkv, f) is None else getattr(pkv, f)[:, [page]]
          for f in cache_mod.PageWire._fields[:-1]), ring=pkv.ring[:, 0])
    kv = scheduler._host_fields(wire)
    return [transport.page_payload(kv, codec_on, 0, l, 0)
            for l in range(pkv.ring.shape[0])]


def prefix_stats_line(st):
    return (f"{st.tokens_per_s:.2f} tok/s, TTFT mean "
            f"{st.ttft_mean_s * 1e3:.1f} / p50 {st.ttft_p50_s * 1e3:.1f} / "
            f"p95 {st.ttft_p95_s * 1e3:.1f} ms, wall {st.wall_s:.2f}s, "
            f"{st.n_admit_dispatches} admissions (batched prefills) of "
            f"{st.n_requests} requests, {st.n_replay_dispatches} replay "
            f"windows, {st.shared_page_hits} shared page hits "
            f"({st.cache_hot_hits} hot re-acquires), "
            f"{st.cache_spilled_pages} pages / {st.cache_spilled_bytes} B "
            f"spilled, {st.cache_fetched_pages} pages / "
            f"{st.cache_fetched_bytes} B fetched, {st.cache_evicted_cols} "
            f"columns evicted, {st.cache_reprefill_cols} re-prefills, "
            f"{st.eager_steps} eager + {st.graph_replays} replayed steps")


def prefix_phase(cfg, params, smi):
    """Serve a shared-prefix mix on full-width qwen3-4b, raw weights,
    block 256, 4 slots of 4096 tokens (72 pool columns): sharing on from
    CUDA graphs, the warm tier restoring the duplicates after an eviction
    of every retained column, sharing off, a sub-mix eager against graphs,
    and the launcher's tail-free demo mix on and off."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.serve.digest import page_digest
    from repro_torch.serve.scheduler import (Request, ServeEngine,
                                             demo_serving_setup, format_stats)

    run = RunConfig(codec=CodecConfig(cache_block=PREFIX_BLK))
    reqs, dups = prefix_mix(cfg, np.random.default_rng(11))
    t_phase = time.perf_counter()

    def engine(sharing=True, graphs=True, run_=run, max_len=PREFIX_MAX_LEN):
        return ServeEngine(cfg, run_, n_slots=4, max_len=max_len,
                           params=params, device="cuda", cuda_graphs=graphs,
                           prefix_sharing=sharing)

    # sharing on, from CUDA graphs: the path's kernels counted in this run
    eng = engine()
    assert eng.state.kv.page_used.shape[0] == 72
    probe = SharingProbe(eng)
    ops.reset_launch_counts()
    results, st = eng.run(reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    streams = {r.uid: r.tokens for r in results}
    for req, res in zip(reqs, results):
        assert len(res.tokens) == req.max_new_tokens, (req.uid, res)
    assert all(launches[name] > 0 for name in SERVE_KERNELS), launches
    check_graph_run(cfg, st, launches)
    assert st.shared_page_hits > 0 and st.cache_hot_hits > 0, st
    assert st.n_admit_dispatches < st.n_requests, st
    assert st.cache_evicted_cols > 0, st
    for dup, orig in dups.items():
        assert streams[dup] == streams[orig], (dup, orig)
    log("prefix", f"sharing on, CUDA graphs: " + format_stats(st)
        .replace("\n", " | "))
    log("prefix", f"sharing on, CUDA graphs, {len(reqs)} requests: "
                  f"{prefix_stats_line(st)}; {probe.line()}; launches "
                  f"{launches}; duplicates {sorted(dups.items())} "
                  f"(duplicate, original): streams equal | {smi}")

    # the warm tier: evict every retained column, then the duplicates
    # again restore from the spilled bytes with no prefill
    st0 = st
    on_hits = {h["uid"]: h["m"] for h in probe.hits}
    hit_uids = set(on_hits)
    n_evict = eng.cache.retained()
    eng._ensure_free_pages(1 << 30)
    assert eng.cache.retained() == 0 and not eng.state.kv.page_used.any()
    probe.hits.clear()
    again = [Request(uid=100 + d, prompt=reqs[d].prompt.copy(),
                     max_new_tokens=reqs[d].max_new_tokens) for d in dups]
    res2, st2 = eng.run(again)
    torch.cuda.synchronize()
    for r, d in zip(res2, dups):
        assert r.tokens == streams[d], (r.uid, d)
    assert st2.n_admit_dispatches == 0, st2
    assert st2.cache_fetched_pages > st0.cache_fetched_pages, st2
    n_pages = 0
    for hit in probe.hits:
        for c in range(hit["h"], hit["m"]):
            key, page = hit["keys"][c], int(hit["row"][c])
            got = pool_page_payloads(eng.state.kv, page, True)
            assert [page_digest(p) for p in got] == eng.cache.warm[key], \
                (hit["uid"], c)
            n_pages += len(got)
    assert n_pages > 0
    log("prefix", f"warm restore: {n_evict} retained columns evicted, the 2 "
                  f"duplicates served again from the warm tier with no "
                  f"prefill, on the same streams; {n_pages} imported pages' "
                  f"bytes hash to their spilled digests; "
                  f"{prefix_stats_line(st2)}; {probe.line()} | {smi}")
    on_batches = probe.batches
    del eng, probe
    torch.cuda.empty_cache()

    # sharing off: the same mix, every request cold
    eng = engine(sharing=False)
    off_probe = SharingProbe(eng)
    res_off, st_off = eng.run(reqs)
    torch.cuda.synchronize()
    off = {r.uid: r.tokens for r in res_off}
    off_batches = off_probe.batches
    del eng, off_probe
    torch.cuda.empty_cache()
    assert st_off.shared_page_hits == 0 and st_off.cache_spilled_pages == 0
    log("prefix", f"sharing off, CUDA graphs: {prefix_stats_line(st_off)} "
                  f"| {smi}")
    near_ties("prefix mix", cfg, run, params, reqs, streams, off, on_batches,
              on_hits, off_batches, hit_uids)

    # the first 6 requests (4 cold, 2 hits) eagerly and from graphs
    sub = reqs[:6]
    got = {}
    for graphs in (False, True):
        eng = engine(graphs=graphs)
        res, st_sub = eng.run(sub)
        torch.cuda.synchronize()
        assert st_sub.shared_page_hits > 0
        got[graphs] = ([r.tokens for r in res], pool_snapshot(eng.state.kv),
                       st_sub)
        del eng
    assert got[True][0] == got[False][0], "sub-mix: graph != eager"
    n_bytes = same_pools(got[True][1], got[False][1])
    log("prefix", f"the first 6 requests (sharing on), eager and from CUDA "
                  f"graphs: the same streams, page table, page use and all "
                  f"{n_bytes} B of pages and rings; eager "
                  f"{prefix_stats_line(got[False][2])}; graphs "
                  f"{prefix_stats_line(got[True][2])} | {smi}")
    del got
    torch.cuda.empty_cache()

    # the replay cost of a hit: the launcher's tail-free demo mix (prompts
    # 1024 / 512 at block 256), sharing on and off
    demo = {}
    run_d, max_len, dreqs = demo_serving_setup(run, cfg.vocab_size, 1024, 16,
                                               6)
    for sharing in (True, False):
        eng = engine(sharing=sharing, run_=run_d, max_len=max_len)
        dprobe = SharingProbe(eng)
        res, st_d = eng.run(dreqs)
        demo[sharing] = ({r.uid: r.tokens for r in res}, st_d,
                         dprobe.batches,
                         {h["uid"]: h["m"] for h in dprobe.hits})
        log("prefix", f"demo mix, sharing {'on' if sharing else 'off'}: "
                      f"{prefix_stats_line(st_d)}; TTFT per request "
                      f"{[round(r.ttft_s * 1e3, 1) for r in res]} ms | {smi}")
        del eng, dprobe
    assert demo[True][1].shared_page_hits > 0
    near_ties("demo mix", cfg, run_d, params, dreqs, demo[True][0],
              demo[False][0], demo[True][2], demo[True][3], demo[False][2],
              set(demo[True][3]), max_len=max_len)
    log("prefix", f"demo mix: TTFT mean {demo[False][1].ttft_mean_s * 1e3:.1f}"
                  f" (off) -> {demo[True][1].ttft_mean_s * 1e3:.1f} ms (on); "
                  f"the phase took {time.perf_counter() - t_phase:.1f}s")
    torch.cuda.empty_cache()


def near_ties(label, cfg, run, params, reqs, on, off, on_batches, on_hits,
              off_batches, hit_uids, max_len=PREFIX_MAX_LEN):
    """Sharing on against off: the share of equal tokens, and at each
    request's first divergence both runs' paths teacher-forced
    (``teacher_forced_paths``): the pages the request started from
    prefilled again in the batch that made them -- off: its own batch; on:
    its own, or for a hit the first cold request of the on-run whose
    prompt shares the hit's mapped columns, kept to those columns -- then
    the rest of the prompt and the on-run's tokens fed through decode
    steps.  Each divergence must be a near-tie: a top-2 margin within the
    largest gap between the two paths' logits."""
    import numpy as np
    blk = run.codec.cache_block
    first = divergences("prefix", f"{label}, sharing on vs off", on, off)

    def on_start(uid):
        if uid in on_batches:
            return on_batches[uid], on_batches[uid][0].shape[1]
        for u in sorted(on_batches):
            keep = min(on_hits[uid] * blk, on_batches[u][0].shape[1])
            if np.array_equal(reqs[u].prompt[:keep], reqs[uid].prompt[:keep]):
                return on_batches[u], keep
        raise AssertionError(f"{label}: no cold provider for uid {uid}")

    def paths_of(uid, pos):
        forced = np.asarray(on[uid][:pos], np.int32)
        return [(start, keep, np.concatenate([reqs[uid].prompt[keep:],
                                              forced]))
                for start, keep in (on_start(uid), (
                    off_batches[uid], off_batches[uid][0].shape[1]))]

    check_ties("prefix", label, cfg, run, params, first, on, off, paths_of,
               max_len, lambda uid, pos: ("hit" if uid in hit_uids
                                          else "cold") + " in the on-run",
               ("on", "off"))


def divergences(phase, label, on, off):
    """Log the share of equal tokens of two runs' streams ({uid: tokens});
    returns each differing request's first divergence {uid: position}."""
    n_tok = sum(len(t) for t in off.values())
    same = sum(int(a == b) for u in off for a, b in zip(off[u], on[u]))
    first = {u: next(i for i, (a, b) in enumerate(zip(off[u], on[u]))
                     if a != b)
             for u in off if off[u] != on[u]}
    log(phase, f"{label}: {same}/{n_tok} tokens equal "
               f"({same / n_tok:.4f}); first divergence (uid: position) "
               f"{first}")
    return first


def check_ties(phase, label, cfg, run, params, first, on, off, paths_of,
               max_len, describe, names):
    """Teacher-force each divergence {uid: position} through both runs'
    paths (``paths_of(uid, pos)`` -> [path of ``on``, path of ``off``], as
    ``teacher_forced_paths`` takes them; two divergences per call) and
    require a near-tie: the smaller top-2 margin within the largest gap
    between the two paths' logits.  ``describe(uid, pos)`` names the
    on-run's path in the log, ``names`` the two runs."""
    todo = sorted(first.items())
    for i in range(0, len(todo), 2):
        paths = [p for uid, pos in todo[i:i + 2] for p in paths_of(uid, pos)]
        logits = teacher_forced_paths(cfg, run, params, paths, max_len)
        for j, (uid, pos) in enumerate(todo[i:i + 2]):
            a, b = logits[2 * j], logits[2 * j + 1]
            m_on, m_off, gap = logit_margins(a, b)
            tie = min(m_on, m_off) <= gap
            n_on, n_off = names
            log(phase, f"{label}, uid {uid} position {pos} "
                       f"({describe(uid, pos)};"
                       f" {n_on} token {on[uid][pos]}, {n_off} "
                       f"{off[uid][pos]}; teacher-forced argmax {n_on} "
                       f"{int(a.argmax())} / {n_off} {int(b.argmax())}): "
                       f"top-2 margin {n_on} {m_on:.4g} / {n_off} "
                       f"{m_off:.4g}, largest logit gap {gap:.4g}: "
                       f"{'near-tie' if tie else 'MARGIN ABOVE THE GAP'}")
            assert tie, (label, uid, pos, m_on, m_off, gap)


def teacher_forced_paths(cfg, run, params, paths, max_len):
    """Up to 4 paths through the paged engine's decode, one slot each:
    ``(start, keep, feed)``, where ``start`` is either a batch = (tokens
    (B, T) on the card, row), a batched prefill whose row's first ``keep``
    tokens of pages (whole columns, or the whole row with its ring) start
    the slot, or a host ``SequenceBlob`` imported whole into the slot
    (``keep`` unused), and ``feed`` the tokens then fed one decode step at
    a time (all 4 slots' rows computed every step, as the engine runs
    them; steps from the CUDA graph, each path's last step eager).
    Returns each path's logits (Vp,) after its feed (a batch's prefill's
    own when the feed is empty)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.serve import disagg, engine

    dev = params["embed"].device
    st = engine.empty_paged_state(cfg, run, 4, max_len, device=dev)
    blk = run.codec.cache_block
    out = [None] * len(paths)
    for slot, (start, keep, feed) in enumerate(paths):
        if isinstance(start, disagg.SequenceBlob):
            assert len(feed), "a blob path needs a feed"
            engine.import_slot(st, slot, disagg.blob_wire(start, dev),
                               start.length)
            continue
        toks, row = start
        logits, d = engine.prefill_sequences(cfg, run, params, toks)
        one = engine.PrefilledSequences(kv=[dataclasses.replace(
            kvb, **{f: getattr(kvb, f)[row:row + 1] for f in
                    ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
                     "raw_blocks", "ring") if getattr(kvb, f) is not None})
            for kvb in d.kv], length=d.length)
        engine.insert_sequences(cfg, run, st, one, [slot])
        if keep < d.length:           # a hit: its mapped columns only
            assert keep % blk == 0, keep
            st.kv.page_table[slot, keep // blk:] = -1
            st.kv.touch()
            st.kv.ring[:, slot].zero_()
            st.lengths[slot] = keep
        if not len(feed):
            out[slot] = logits[row, -1]
        del d, one, logits
    graph = engine.PagedDecoder(cfg, run, st, graphs=True)
    eager = engine.PagedDecoder(cfg, run, st, graphs=False)
    n = [len(f) for _, _, f in paths]
    for t in range(max(n)):
        active = np.array([slot < len(paths) and t < n[slot]
                           for slot in range(4)])
        tok = torch.tensor([[int(paths[s][2][t]) if active[s] else 0]
                            for s in range(4)], dtype=torch.int32)
        last = active & np.array([s < len(paths) and t == n[s] - 1
                                  for s in range(4)])
        dec = eager if last.any() else graph
        dec.tok.copy_(tok)
        logits = dec.forward(params, active)
        for s in np.flatnonzero(last):
            out[s] = logits[s, -1]
    return out


# ---------------------------------------------------------------------------
# phase 10: disaggregated serving
# ---------------------------------------------------------------------------

DISAGG_BLK, DISAGG_MAX_LEN, DISAGG_SEED = 256, 2048, 0
STAT_BYTES = ("n_transfers", "wire_bytes", "wire_bytes_nodedup",
              "wire_raw_bytes", "dedup_page_refs", "pages_streamed",
              "stream_chunk_bytes", "pages_resent", "store_evicted",
              "decode_prefix_hits", "link_model_ms", "link_model_ms_raw")


class DisaggProbe:
    """Watches one in-process ``DisaggEngine``: each closing export
    (``PrefillReplica._export_blob``) and each import
    (``DecodeReplica.import_handoff``) timed from a synchronised card to a
    synchronised card, per page column; the prefill replicas' batched
    prefills (for the teacher-forced check).  With ``reexport``, every
    slot is exported again from the decode replica right after its import
    (outside the timed span): the blob's ring, length, tokens and every
    column not mapped from an earlier import must be its bytes, and the
    re-exported state is kept per uid."""

    def __init__(self, dis, reexport=False):
        import torch
        self.sync = torch.cuda.synchronize
        self.export_s = self.import_s = 0.0
        self.export_cols = self.import_cols = self.n_imports = 0
        self.post, self.checked = {}, 0
        self.mapped_cols = self.mapped_differ = 0
        self.sharing = [SharingProbe(pr.engine) for pr in dis.prefills]
        for pr in dis.prefills:
            export = pr._export_blob

            def export_blob(s, export=export):
                self.sync()
                t0 = time.perf_counter()
                blob = export(s)
                self.sync()
                self.export_s += time.perf_counter() - t0
                self.export_cols += blob.n_cols
                return blob

            pr._export_blob = export_blob
        for dr in dis.decodes:
            imp = dr.import_handoff

            def import_handoff(h, dr=dr, imp=imp):
                hits0 = dr.ls.shared_hits
                self.sync()
                t0 = time.perf_counter()
                slot = imp(h)
                self.sync()
                self.import_s += time.perf_counter() - t0
                self.import_cols += h.blob.n_cols
                self.n_imports += 1
                if reexport:
                    self.check(dr, h, slot, dr.ls.shared_hits - hits0)
                return slot

            dr.import_handoff = import_handoff

    @property
    def batches(self):
        """{uid: (batch tokens, row)} of the prefill replicas' prefills."""
        return {u: b for p in self.sharing for u, b in p.batches.items()}

    def check(self, dr, h, slot, m):
        import numpy as np
        from repro_torch.serve.disagg import PrefillReplica
        pr = PrefillReplica(dr.engine)
        pr.ls = dr.ls
        post = pr._export_blob(slot)
        blob = h.blob
        assert (post.length, post.cur_token, post.emitted, post.n_cols) == \
            (blob.length, blob.cur_token, blob.emitted, blob.n_cols)
        np.testing.assert_array_equal(post.kv["ring"], blob.kv["ring"])
        for f in blob.kv:
            if f != "ring":
                np.testing.assert_array_equal(post.kv[f][:, :, m:],
                                              blob.kv[f][:, :, m:])
                if m:
                    self.mapped_differ += int(not np.array_equal(
                        post.kv[f][:, :, :m], blob.kv[f][:, :, :m]))
        if not m:
            assert post.to_wire(None)[0] == blob.to_wire(None)[0]
        self.mapped_cols += m
        self.checked += 1
        self.post[h.req.uid] = post

    def line(self):
        return (f"export {self.export_cols} columns in "
                f"{self.export_s * 1e3:.1f} ms "
                f"({self.export_s * 1e3 / max(self.export_cols, 1):.2f} ms "
                f"per column), import {self.import_cols} columns in "
                f"{self.import_s * 1e3:.1f} ms "
                f"({self.import_s * 1e3 / max(self.import_cols, 1):.2f} ms "
                f"per column, {self.n_imports} imports)")


def disagg_stats_line(st):
    return (f"{st.tokens_per_s:.2f} tok/s, TTFT mean "
            f"{st.ttft_mean_s * 1e3:.1f} / p50 {st.ttft_p50_s * 1e3:.1f} / "
            f"p95 {st.ttft_p95_s * 1e3:.1f} ms, wall {st.wall_s:.2f}s, "
            f"{st.n_admit_dispatches} admissions, {st.n_replay_dispatches} "
            f"replay windows, {st.decode_steps} decode steps; "
            f"{st.n_transfers} transfers: wire {st.wire_bytes} B against "
            f"{st.wire_raw_bytes} B raw bf16 (link_reduction "
            f"{st.link_reduction:.4f}), codec-only {st.wire_bytes_nodedup} "
            f"B, {st.dedup_page_refs} dedup references, "
            f"{st.pages_streamed} pages streamed in "
            f"{st.stream_chunk_bytes} B of chunks, {st.decode_prefix_hits} "
            f"import prefix hits; LinkModel (modelled, 100 Gb/s chiplet "
            f"link, not measured) {st.link_model_ms:.3f} ms compressed vs "
            f"{st.link_model_ms_raw:.3f} ms raw; transfer "
            f"{st.transfer_mean_s * 1e3:.2f} ms per handoff (host, mean)")


def disagg_paths(on, reqs, probe, off_batches):
    """``paths_of(uid, pos)`` for ``check_ties``: the disaggregated run's
    path (a ``DisaggProbe(reexport=True)`` watched it) against the
    monolithic run's batched prefill.  At position 0 the first token is
    the prefill replica's, so its path is its prefill batch; later, the
    decode replica's state re-exported right after the import, as a
    ``SequenceBlob``."""
    import numpy as np

    def paths_of(uid, pos):
        forced = np.asarray(on[uid][:pos], np.int32)
        ob = off_batches[uid]
        off_path = (ob, ob[0].shape[1], np.concatenate(
            [reqs[uid].prompt[ob[0].shape[1]:], forced]))
        if pos == 0:
            b = probe.batches[uid]
            return [(b, b[0].shape[1], np.concatenate(
                [reqs[uid].prompt[b[0].shape[1]:], forced])), off_path]
        return [(probe.post[uid], None, forced), off_path]

    return paths_of


def describe_disagg_path(uid, pos):
    return ("disagg from its prefill batch" if pos == 0 else
            "disagg from the decode replica's state after its import")


def disagg_phase(cfg, params, smi):
    """Disaggregated prefill -> decode serving on full-width ``cfg`` (raw
    ``params``; the decode host process draws the same from the seed at
    ``cfg``'s depth), block 256, 4 slots of 2048 tokens per replica, on
    two mixes, each four ways: (a) 1 prefill -> 1 decode
    replica over the loopback transport, (b) the same with streaming
    export, (c) 1 prefill -> 2 decode replicas, (d) the decode replica in
    a second OS process on the card (``launch.disagg_host``), over TCP,
    streaming.  Returns the kernel launches of the in-process runs."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.disagg_host import (param_digest,
                                                spawn_decode_host,
                                                stop_child)
    from repro_torch.serve import DisaggEngine, SocketTransport
    from repro_torch.serve.digest import page_digest
    from repro_torch.serve.scheduler import ServeEngine, demo_serving_setup

    t_phase = time.perf_counter()
    run = RunConfig(codec=CodecConfig(cache_block=DISAGG_BLK))
    run_d, _, demo = demo_serving_setup(run, cfg.vocab_size, 1024, 16, 6)
    assert run_d == run
    mixes = (("demo mix", demo),
             ("serve mix", serve_mix(cfg, np.random.default_rng(0))))
    kw = dict(n_slots=4, max_len=DISAGG_MAX_LEN, params=params,
              seed=DISAGG_SEED, device="cuda")
    launches = {name: 0 for name in SERVE_KERNELS}
    host_flags = ["--model", cfg.name, "--no-reduced", "--layers",
                  str(cfg.n_layers), "--codec", "on",
                  "--cache-block", str(DISAGG_BLK), "--slots", "4",
                  "--max-len", str(DISAGG_MAX_LEN), "--seed",
                  str(DISAGG_SEED), "--device", "cuda"]
    mine = param_digest(params)
    procs = []
    try:
        for label, reqs in mixes:
            mono = ServeEngine(cfg, run, prefix_sharing=False, **kw)
            mono_probe = SharingProbe(mono)
            res, st_m = mono.run(reqs)
            torch.cuda.synchronize()
            off = {r.uid: r.tokens for r in res}
            off_batches = mono_probe.batches
            del mono, mono_probe
            gc.collect()
            torch.cuda.empty_cache()
            log("disagg", f"{label}, monolithic (sharing off, CUDA graphs): "
                          f"{prefix_stats_line(st_m)} | {smi}")

            streams, stats = {}, {}
            ops.reset_launch_counts()
            for way, n_decode, streaming in (("a", 1, False), ("b", 1, True),
                                             ("c", 2, False)):
                dis = DisaggEngine(cfg, run, n_decode=n_decode,
                                   streaming=streaming, **kw)
                probe = DisaggProbe(dis, reexport=way == "a")
                res, st = dis.run(reqs)
                torch.cuda.synchronize()
                for req, r in zip(reqs, res):
                    assert len(r.tokens) == req.max_new_tokens, (way, r)
                streams[way] = {r.uid: r.tokens for r in res}
                stats[way] = st
                for name, t in dis.transport._stores.items():
                    for d, payload in t._lru.items():
                        assert page_digest(payload) == d, (way, name)
                n_store = sum(len(t) for t in dis.transport._stores.values())
                log("disagg", f"{label} ({way}) 1 prefill -> {n_decode} "
                              f"decode, {'streaming' if streaming else 'whole'}"
                              f" export: {disagg_stats_line(st)}; "
                              f"{probe.line()}; {n_store} pages in the "
                              f"receivers' stores hash to their digests | "
                              f"{smi}")
                if way == "a":
                    assert probe.checked == st.n_transfers > 0
                    log("disagg", f"{label} (a): all {probe.checked} "
                                  f"handoffs re-exported from the decode "
                                  f"replica right after the import: ring, "
                                  f"length, tokens and every imported column"
                                  f" equal the blob's (the imports without "
                                  f"a prefix hit: to_wire(None) byte for "
                                  f"byte); {probe.mapped_cols} columns "
                                  f"mapped from earlier imports, "
                                  f"{probe.mapped_differ} of their fields "
                                  f"differ from the blob's own pages")
                    a_probe = probe
                del dis, probe
                gc.collect()          # replicas and probes hold cycles
                torch.cuda.empty_cache()
            counts = ops.launch_counts()
            assert all(counts[n] > 0 for n in SERVE_KERNELS), counts
            for n in SERVE_KERNELS:
                launches[n] += counts[n]

            # (d): a fresh decode host per mix (one session each)
            t0 = time.perf_counter()
            proc, port, host_params = spawn_decode_host(host_flags,
                                                        timeout=600.0)
            procs.append(proc)
            assert host_params == mine, (host_params, mine)
            log("disagg", f"decode host (pid {proc.pid}, port {port}) up in "
                          f"{time.perf_counter() - t0:.1f}s; its weights, "
                          f"drawn from seed {DISAGG_SEED} on the card, equal"
                          f" the driver's (param_digest {mine})")
            tr = SocketTransport(timeout=600.0)
            dis = DisaggEngine(cfg, run, transport=tr, streaming=True,
                               decode_addrs=[f"127.0.0.1:{port}"], **kw)
            res, st = dis.run(reqs)
            tr.close()
            assert proc.wait(timeout=60) == 0
            streams["d"] = {r.uid: r.tokens for r in res}
            stats["d"] = st
            del dis
            gc.collect()
            torch.cuda.empty_cache()
            log("disagg", f"{label} (d) 1 prefill -> 1 decode replica in a "
                          f"second process, TCP, streaming: "
                          f"{disagg_stats_line(st)} | {smi}")
            for way in "bcd":
                assert streams[way] == streams["a"], (label, way)
            for f in STAT_BYTES:
                assert getattr(stats["b"], f) == getattr(stats["d"], f), f
            log("disagg", f"{label}: the streams of (a)-(d) are equal bit for "
                          f"bit; (b) and (d) report the same wire-byte "
                          f"counters ({', '.join(STAT_BYTES)}); every "
                          f"budget met; kernel launches (a)-(c) {counts}")
            first = divergences("disagg", f"{label}, disaggregated (a) vs "
                                          f"monolithic", streams["a"], off)
            on = streams["a"]
            check_ties("disagg", f"{label}, disaggregated vs monolithic", cfg,
                       run, params, first, on, off,
                       disagg_paths(on, reqs, a_probe, off_batches),
                       DISAGG_MAX_LEN, describe_disagg_path,
                       ("disagg", "mono"))
            del a_probe
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for proc in procs:
            if proc.poll() is None:
                stop_child(proc)
    log("disagg", f"kernel launches of the in-process disaggregated runs "
                  f"{launches}; the phase took "
                  f"{time.perf_counter() - t_phase:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the parallel attention ∥ SSM hybrid (zamba2-1.2b)
# ---------------------------------------------------------------------------

HYBRID_BLK = 256


def same_ssm(a, b) -> int:
    """Assert two SSM states (``models.ssm.SSMState``) byte-identical;
    returns the bytes held."""
    import torch
    n = 0
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        n += x.numel() * x.element_size()
    return n


def tiny_hybrid_cfg():
    """The reference tests' hybrid (``tests/test_serve_engine.py``): 3
    layers, hymba_3global windows, Mamba2 with d_state 16."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    return ModelConfig(
        name="h", family="hybrid", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=500, head_dim=16,
        parallel_hybrid=True, attn_layout="hymba_3global", window=16,
        ssm=SSMConfig(d_state=16, headdim=8, chunk=16), sub_quadratic=True)


def packed_leaf_checks(cfg, params, packed, gen, phase, tp: int = 1,
                       stacks: bool = False):
    """Both weight kernels on every packed leaf of ``cfg``'s model, at the
    shapes its runs give them: ``weight_case`` on layer 0 of each stacked
    matmul leaf and on the LM head (together, ``weight_shapes(cfg, tp)``'s
    shapes: at tp > 1 ``params`` and ``packed`` are one rank's shards);
    ``stacked_unpack_check`` on the leaves read through
    ``layers.raw_weight`` -- the RAW_READ leaves whole, and a MoE layer's
    expert stacks as one step decodes them, layer 0's (E, K, N) in one
    launch, with ``weight_case`` on its expert 0 as well -- and, with
    ``stacks``, on every stacked matmul leaf whole.  Returns the worst
    max |err| of decompress_matmul over the leaves, by M."""
    import torch
    from repro_torch.core import weights

    def walk(t, path=()):
        if isinstance(t, dict):
            for key, v in t.items():
                yield from walk(v, path + (key,))
        elif isinstance(t, weights.PackedWeight):
            yield path, t

    def matmul_line(name, w, pw, errs):
        log(phase, f"decompress_matmul on {name} (K={w.shape[0]}, N="
                   f"{w.shape[1]}, k={pw.k}): max |err| at M=4 "
                   f"{errs[4]:.3e}, at M=1024 {errs[1024]:.3e}, within "
                   f"1e-4*(|x|@|W|)+1e-6 of the plain version, two "
                   f"launches bit for bit; lexi_unpack exact, == plain")

    shapes, n_leaves, worst = set(), 0, {4: 0.0, 1024: 0.0}
    for path, pw in walk(packed):
        w, name = _at(params, path), "/".join(path)
        n_leaves += 1
        expert = path[-2:-1] == ("moe",) and path[-1] in EXPERT_STACKS
        if path[-1] in RAW_READ or expert:
            if expert:
                w, pw, name = w[0], pw[0], name + "[0]"
            stacked_unpack_check(w, pw)
            log(phase, f"lexi_unpack on {name} {tuple(w.shape)} (k="
                       f"{pw.k}, read through raw_weight), one launch: "
                       f"exact, and equal to the plain version row by row")
            if expert:
                errs = {m: e for m, (_, e) in
                        weight_case(w[0], pw[0], gen).items()}
                matmul_line(name + "[0]", w[0], pw[0], errs)
                worst = {m: max(worst[m], errs[m]) for m in worst}
            torch.cuda.empty_cache()
            continue
        if pw.ndim == 3:
            if stacks:
                stacked_unpack_check(w, pw)
                log(phase, f"lexi_unpack on {name} {tuple(w.shape)} (k="
                           f"{pw.k}), one launch: exact, and equal to the "
                           f"plain version layer by layer")
            w, pw, name = w[0], pw[0], name + "[0]"
        errs = {m: e for m, (_, e) in weight_case(w, pw, gen).items()}
        worst = {m: max(worst[m], errs[m]) for m in worst}
        shapes.add(tuple(w.shape))
        matmul_line(name, w, pw, errs)
        torch.cuda.empty_cache()
    assert shapes == {s_ for s_, _ in weight_shapes(cfg, tp)}, shapes
    log(phase, f"{cfg.name}: all {n_leaves} packed leaves checked")
    return worst


def hybrid_prefill_slots(cfg, eng, n_tok: int, seed: int):
    """Four fresh ``n_tok``-token sequences prefilled into slots 0-3 of an
    idle engine; returns the greedy tokens that follow them."""
    import numpy as np
    import torch
    from repro_torch.serve import engine

    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, n_tok)),
                              dtype=torch.int32, device="cuda")
    logits, d = engine.prefill_sequences(cfg, eng.run_cfg, eng.params,
                                         prompts)
    engine.insert_sequences(cfg, eng.run_cfg, eng.state, d, [0, 1, 2, 3])
    return engine.greedy_token(logits)


def ssm_step_ms(cfg, eng) -> float:
    """Device ms of one step's SSM work alone (every layer's
    ``ssm_decode_step`` and its masked in-place state write, 4 slots),
    replayed from a CUDA graph on a copy of the engine's state."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import lm, ssm as ssm_mod

    st = ssm_mod.SSMState(*(t.clone() for t in eng.state.ssm))
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((4, 1, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    active = torch.ones((4,), dtype=torch.bool, device="cuda")
    ps = [lm.layer_params(eng.params, i)["ssm"] for i in range(cfg.n_layers)]

    def body():
        for i, p in enumerate(ps):
            sst = ssm_mod.take(st, i)
            _, new = ssm_mod.ssm_decode_step(cfg, p, x, sst)
            ssm_mod.write_state(sst, new, active)

    graph = ops.CapturedStep(body, body, "cuda")
    return cuda_ms(graph.replay, reps=10, spin=False)


def hybrid_phase(smi):
    """The parallel attention ∥ SSM hybrid: full-width zamba2-1.2b (its
    first HYBRID_LAYERS of 26 layers, random weights from seed 0) through
    every serving path of the dense family.
    Returns the kernel launches of its runs from CUDA graphs (replays
    counted) and of its packed run."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import weights
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import DisaggEngine, engine
    from repro_torch.serve.scheduler import Request, ServeEngine

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("zamba2-1.2b"),
                              n_layers=HYBRID_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(11)
    paged_attend_kernel(cfg, gen, "hybrid")
    fixed_attend_kernel(cfg, gen, "hybrid")
    for packed in (False, True):
        ops.reset_launch_counts()
        worst = small_model_diff(packed, tiny_hybrid_cfg())
        assert (ops.launch_counts()["decompress_matmul"] > 0) == packed
        log("hybrid", f"tiny hybrid (hymba_3global, 3 layers), "
                      f"{'packed' if packed else 'raw'} weights, prefill + "
                      f"10 teacher-forced steps: card vs CPU logits max "
                      f"|diff| {worst:.2e} (<= 1e-2)")

    blk = HYBRID_BLK
    run = RunConfig(codec=CodecConfig(cache_block=blk))
    kw = dict(n_slots=4, max_len=8 * blk, seed=0, device="cuda")
    reqs = serve_mix(cfg, np.random.default_rng(0))
    launches = {name: 0 for name in REPLACES}
    runs = {}
    params = None
    for graphs in (False, True):
        eng = ServeEngine(cfg, run, params=params, cuda_graphs=graphs,
                          prefix_sharing=False, **kw)
        params = eng.params
        ops.reset_launch_counts()
        results, st = eng.run(reqs)
        torch.cuda.synchronize()
        for req, res in zip(reqs, results):
            assert len(res.tokens) == req.max_new_tokens, (req.uid, res)
        runs[graphs] = (eng, [r.tokens for r in results], st,
                        ops.launch_counts())
    (e_eng, e_tok, e_st, _), (g_eng, g_tok, g_st, g_l) = runs[False], \
        runs[True]
    assert g_tok == e_tok, "hybrid: graph streams != eager"
    n_pool = same_pools(pool_snapshot(e_eng.state.kv, clone=False),
                        pool_snapshot(g_eng.state.kv, clone=False))
    n_ssm = same_ssm(e_eng.state.ssm, g_eng.state.ssm)
    passes = check_graph_run(cfg, g_st, g_l)
    assert all(g_l[n] > 0 for n in SERVE_KERNELS), g_l
    for n in SERVE_KERNELS:
        launches[n] += g_l[n]
    assert g_st.n_replay_dispatches == 0          # the exact trunk
    assert g_st.n_admit_dispatches == len(reqs)   # 6 distinct lengths
    w_bytes = weights.weight_plane_bytes(params)
    log("hybrid", f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
                  f"{cfg.n_heads}/{cfg.n_kv_heads} heads, SSM d_inner "
                  f"{cfg.ssm.d_inner(cfg.d_model)} (64 heads x 64, d_state "
                  f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk}), vocab "
                  f"{cfg.vocab_size}; weights {w_bytes[0]} B | {smi}")
    log("hybrid", f"serve mix (6 requests, 4 slots, block {blk}, prompts "
                  f"250-1100, exact trunks: {g_st.n_admit_dispatches} "
                  f"admissions, no replay) from CUDA graphs: the eager run's "
                  f"streams ({sum(map(len, g_tok))} tokens), page table, "
                  f"page use, all {n_pool} B of pages and rings and all "
                  f"{n_ssm} B of SSM state bit for bit; {g_st.eager_steps} "
                  f"eager (= flushing) steps, {g_st.graph_replays} replayed; "
                  f"pool {engine.paged_state_nbytes(g_eng.state)} B; "
                  f"launches {g_l} ({cfg.n_layers} x {passes} passes)")
    for graphs, (_, _, st, _) in sorted(runs.items()):
        log("hybrid", f"serve mix, {'CUDA graphs' if graphs else 'eager'}: "
                      f"{st.tokens_per_s:.2f} tok/s, TTFT mean "
                      f"{st.ttft_mean_s * 1e3:.1f} ms, inter-token "
                      f"{st.inter_token_mean_s * 1e3:.2f} ms, wall "
                      f"{st.wall_s:.2f}s | {smi}")
    del runs, e_eng
    gc.collect()
    torch.cuda.empty_cache()

    # 8 decode steps of 4 fresh 1000-token slots, eager and from the
    # graph, profiled; the SSM work's share of the graph step's device time
    tok = hybrid_prefill_slots(cfg, g_eng, 1000, seed=3)
    prof = profile_decode(cfg, g_eng, tok, "decode_hybrid")
    ssm_ms, g = ssm_step_ms(cfg, g_eng), prof["graph"]
    log("hybrid", f"decode step, 4 slots at ~1000 tokens, from the graph: "
                  f"host {g['host_ms']:.3f} ms/step, device busy "
                  f"{g['busy_ms']:.3f} ms/step, {g['tok_s']:.1f} tok/s; the "
                  f"SSM work alone ({cfg.n_layers} layers, replayed from its "
                  f"own graph) {ssm_ms:.3f} ms = "
                  f"{100 * ssm_ms / g['busy_ms']:.1f}% of the step's busy "
                  f"time | {smi}")
    del g_eng
    gc.collect()
    torch.cuda.empty_cache()

    # a snapshot hit: a page-aligned prompt served twice with sharing on
    rng = np.random.default_rng(4)
    p512 = rng.integers(0, cfg.vocab_size, (2 * blk,)).astype(np.int32)
    eng = ServeEngine(cfg, run, params=params, **kw)
    ops.reset_launch_counts()
    res, st = eng.run([Request(uid=0, prompt=p512, max_new_tokens=12),
                       Request(uid=1, prompt=p512.copy(),
                               max_new_tokens=12)])
    torch.cuda.synchronize()
    for n_, c_ in ops.launch_counts().items():
        launches[n_] += c_ if n_ in SERVE_KERNELS else 0
    assert res[0].tokens == res[1].tokens, "snapshot hit: streams differ"
    assert st.n_admit_dispatches == 1 and st.shared_page_hits == 2, st
    assert len(eng.cache.snapshots) == 1
    log("hybrid", f"snapshot hit: a {2 * blk}-token prompt served twice "
                  f"with sharing on: 1 prefill, the second admission maps "
                  f"its {st.shared_page_hits} columns and restores the "
                  f"boundary SSM snapshot (no prefill, no replay); streams "
                  f"equal ({len(res[1].tokens)} tokens)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # disaggregated: 1 prefill -> 1 decode replica over the loopback
    dis = DisaggEngine(cfg, run, params=params, **kw)
    dec, ssm_wire = dis.decodes[0], []
    imp = dec.import_handoff

    def check_import(h):
        s = imp(h)
        got = [t[:, s] for t in dec.engine.state.ssm]
        hh, cx, cbc = h.blob.ssm
        assert torch.equal(got[0].cpu(), torch.from_numpy(hh[0]))
        for t, a in ((got[1], cx), (got[2], cbc)):
            assert np.array_equal(
                t.view(torch.int16).cpu().numpy().view(np.uint16), a[0])
        ssm_wire.append(sum(a.nbytes for a in h.blob.ssm))
        return s

    dec.import_handoff = check_import
    ops.reset_launch_counts()
    res, dst = dis.run(reqs)
    torch.cuda.synchronize()
    for n_, c_ in ops.launch_counts().items():
        launches[n_] += c_ if n_ in SERVE_KERNELS else 0
    assert [r.tokens for r in res] == g_tok, "disagg streams != monolithic"
    assert len(ssm_wire) == dst.n_transfers > 0
    log("hybrid", f"disagg 1 prefill -> 1 decode (loopback): the monolithic "
                  f"streams bit for bit; {dst.n_transfers} handoffs, each "
                  f"decode slot's imported SSM state byte-identical to the "
                  f"prefill replica's export; wire {dst.wire_bytes} B of "
                  f"{dst.wire_raw_bytes} B raw (link_reduction "
                  f"{dst.link_reduction:.4f}), of which the raw SSM section "
                  f"{sum(ssm_wire)} B ({sum(ssm_wire) // dst.n_transfers} B "
                  f"a handoff); {dst.tokens_per_s:.2f} tok/s, TTFT mean "
                  f"{dst.ttft_mean_s * 1e3:.1f} ms, transfer "
                  f"{dst.transfer_mean_s * 1e3:.1f} ms a handoff | {smi}")
    del dis, dec
    gc.collect()
    torch.cuda.empty_cache()

    # the packed weight plane, the serve mix's first 3 requests from CUDA
    # graphs: ``unpack`` (exact decode, then the raw product) must give
    # the raw streams; ``cuda`` launches both weight kernels (conv_x
    # through lexi_unpack); its first divergence from the raw stream is
    # teacher-forced through both stores and must be a near-tie
    packed = weights.pack_serving_params(params, backend="cuda")
    assert isinstance(packed["blocks"]["ssm"]["conv_x"], weights.PackedWeight)
    assert not isinstance(packed["blocks"]["ssm"]["gate_norm"],
                          weights.PackedWeight)
    packed_leaf_checks(cfg, params, packed, gen, "hybrid")
    raw3 = g_tok[:3]
    for be in ("unpack", "cuda"):
        run_be = RunConfig(codec=dataclasses.replace(run.codec,
                                                     weight_backend=be))
        eng = ServeEngine(cfg, run_be, params=packed, compress_weights=True,
                          prefix_sharing=False, **kw)
        assert eng.weight_backend == be
        ops.reset_launch_counts()
        res, st = eng.run(reqs[:3])
        torch.cuda.synchronize()
        pl = ops.launch_counts()
        got = [r.tokens for r in res]
        del eng
        if be == "unpack":
            assert got == raw3, "unpack backend: streams != raw"
            assert pl["lexi_unpack"] > 0 and pl["decompress_matmul"] == 0
            log("hybrid", f"packed weights (unpack backend): the raw run's "
                          f"streams; {st.tokens_per_s:.2f} tok/s")
            continue
        for name in ("decompress_matmul", "lexi_unpack"):
            assert pl[name] > 0, pl
            launches[name] += pl[name]
        same = sum(a == b for r, g in zip(got, raw3) for a, b in zip(r, g))
        log("hybrid", f"packed weights (cuda backend), the serve mix's "
                      f"first 3 requests from CUDA graphs: "
                      f"{st.weight_bytes_per_step} B per step of "
                      f"{st.weight_raw_bytes_per_step} B raw "
                      f"({st.weight_ratio:.3f}); {same}/"
                      f"{sum(map(len, got))} tokens equal to the raw run; "
                      f"{st.tokens_per_s:.2f} tok/s; launches "
                      f"decompress_matmul {pl['decompress_matmul']}, "
                      f"lexi_unpack {pl['lexi_unpack']} | {smi}")
        for uid, (ra, rb) in enumerate(zip(raw3, got)):
            i = next((j for j, (a, b) in enumerate(zip(ra, rb)) if a != b),
                     None)
            if i is None:
                continue
            prompt = torch.as_tensor(reqs[uid].prompt, dtype=torch.int32,
                                     device="cuda")[None]
            forced = torch.as_tensor([ra[:i]], dtype=torch.int32,
                                     device="cuda")
            side = [teacher_forced(cfg, run, w, prompt, prompt.shape[1],
                                   forced, 8 * blk)[i][0]
                    for w in (params, packed)]
            m_raw, m_cuda, gap = logit_margins(*side)
            log("hybrid", f"raw vs cuda, request {uid} position {i}: top-2 "
                          f"margin raw {m_raw:.4g} / cuda {m_cuda:.4g}, "
                          f"largest logit gap {gap:.4g}")
            assert min(m_raw, m_cuda) <= gap, "packed: margin above the gap"
    del packed
    gc.collect()
    torch.cuda.empty_cache()

    # the fixed loop: 4 x 1000 tokens, graph == eager byte for byte
    prompts = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 1000)), dtype=torch.int32, device="cuda")
    launches["decode_attend"] += fixed_graphs(cfg, run, params, prompts,
                                              1000 + 40 + blk, 40, smi)[0]
    log("hybrid", f"phase done in {time.perf_counter() - t_phase:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: MoE and MLA (deepseek-v2-lite-16b), and jamba-tiny-dev
# ---------------------------------------------------------------------------

def tiny_moe_mla_cfg():
    """A tiny MoE + MLA model whose 64-wide latent (48 + 16) the card's
    attention kernels take (the latent width a multiple of 32)."""
    from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
    return ModelConfig(
        name="dv", family="moe", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab_size=512, head_dim=16,
        mla=MLAConfig(kv_lora_rank=48, qk_nope_dim=16, qk_rope_dim=16,
                      v_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1))


def serve_graph_eager(cfg, run, params, reqs, kw):
    """The mix eagerly and from CUDA graphs: streams, page table, page use,
    every pool byte (and a hybrid's SSM state) equal.  Returns (the graph
    engine, the streams, its stats, its launches, pool bytes, SSM bytes,
    the eager run's stats)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import ServeEngine

    runs = {}
    for graphs in (False, True):
        eng = ServeEngine(cfg, run, params=params, cuda_graphs=graphs,
                          prefix_sharing=False, **kw)
        ops.reset_launch_counts()
        results, st = eng.run(reqs)
        torch.cuda.synchronize()
        for req, res in zip(reqs, results):
            assert len(res.tokens) == req.max_new_tokens, (req.uid, res)
        runs[graphs] = (eng, [r.tokens for r in results], st,
                        ops.launch_counts())
    (e_eng, e_tok, e_st, _), (g_eng, g_tok, g_st, g_l) = runs[False], \
        runs[True]
    assert g_tok == e_tok, f"{cfg.name}: graph streams != eager"
    n_pool = same_pools(pool_snapshot(e_eng.state.kv, clone=False),
                        pool_snapshot(g_eng.state.kv, clone=False))
    n_ssm = 0 if cfg.ssm is None else same_ssm(e_eng.state.ssm,
                                               g_eng.state.ssm)
    check_graph_run(cfg, g_st, g_l)
    assert all(g_l[n] > 0 for n in SERVE_KERNELS), g_l
    assert g_st.n_replay_dispatches == 0          # the exact trunk
    return g_eng, g_tok, g_st, g_l, n_pool, n_ssm, e_st


def moe_mla_phase(smi):
    """MoE and MLA on every serving path: both attention kernels' MLA
    latent path at deepseek-v2-lite-16b's shapes and the plain path at
    jamba-tiny-dev's (hd 64); a tiny MoE + MLA model card vs CPU; then
    full-width deepseek-v2-lite-16b (random weights from seed 0, its
    first MOE_MLA_LAYERS of 27 layers) from CUDA graphs against eager, the
    fixed loop, a
    disaggregated fleet and the packed weight plane; full-width
    jamba-tiny-dev from CUDA graphs against eager.  Returns the kernel
    launches of its runs from CUDA graphs (replays counted) and of its
    packed run."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import weights
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import DisaggEngine
    from repro_torch.serve.scheduler import ServeEngine

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=MOE_MLA_LAYERS)
    jamba = get_config("jamba-tiny-dev")
    gen = torch.Generator(device="cuda").manual_seed(12)
    for c_ in (cfg, jamba):
        g = attend_geom(c_)
        timed = (paged_attend_kernel(c_, gen, "moe_mla")[0],
                 fixed_attend_kernel(c_, gen, "moe_mla"))
        for name, row in zip(ATTEND_KERNELS, timed):
            log("moe_mla", f"{name} at {c_.name}'s shapes (H {g.h}/{g.hkv}, "
                           f"q {g.hd} wide, payload {g.w}, out {g.hd_v}): "
                           f"{row['ms']:.4f} ms, bound {row['bound_ms']:.5f} "
                           f"ms ({row['bound_by']}), plain "
                           f"{row['plain_ms']:.3f} ms, SDPA on the "
                           f"decompressed rows {row['library_ms']:.4f} ms, "
                           f"max |err| {row['max_abs_err']:.3e} | {smi}")
    for packed in (False, True):
        ops.reset_launch_counts()
        worst = small_model_diff(packed, tiny_moe_mla_cfg())
        assert (ops.launch_counts()["decompress_matmul"] > 0) == packed
        log("moe_mla", f"tiny MoE + MLA model (2 layers, latent 48 + 16, 8 "
                       f"experts top-2 + 1 shared), "
                       f"{'packed' if packed else 'raw'} weights, prefill + "
                       f"10 teacher-forced steps: card vs CPU logits max "
                       f"|diff| {worst:.2e} (<= 1e-2)")

    blk = HYBRID_BLK
    run = RunConfig(codec=CodecConfig(cache_block=blk))
    kw = dict(n_slots=4, max_len=8 * blk, seed=0, device="cuda")
    reqs = serve_mix(cfg, np.random.default_rng(0))
    launches = {name: 0 for name in REPLACES}
    t0 = time.perf_counter()
    params = engine_params(cfg)
    torch.cuda.synchronize()
    w_bytes = weights.weight_plane_bytes(params)
    log("moe_mla", f"{cfg.name}: {cfg.n_layers} of 27 layers, d="
                   f"{cfg.d_model}, "
                   f"{cfg.n_heads} heads, MLA latent {cfg.mla.kv_lora_rank} "
                   f"+ {cfg.mla.qk_rope_dim} (nope {cfg.mla.qk_nope_dim}, v "
                   f"{cfg.mla.v_dim}), {cfg.moe.n_experts} experts top-"
                   f"{cfg.moe.top_k} (d_ff {cfg.moe.d_ff}) + "
                   f"{cfg.moe.n_shared} shared, vocab {cfg.vocab_size}; "
                   f"{cfg.param_count()} parameters, {w_bytes[0]} B of bf16 "
                   f"weights made on the card in "
                   f"{time.perf_counter() - t0:.1f}s; device memory "
                   f"{torch.cuda.memory_allocated() >> 20} MiB | {smi}")
    g_eng, g_tok, g_st, g_l, n_pool, _, e_st = serve_graph_eager(
        cfg, run, params, reqs, kw)
    for n in SERVE_KERNELS:
        launches[n] += g_l[n]
    log("moe_mla", f"{cfg.name} serve mix (6 requests, 4 slots, block "
                   f"{blk}, prompts 250-1100, {g_st.n_admit_dispatches} "
                   f"admissions of one sequence each, no replay) from CUDA "
                   f"graphs: the eager run's streams "
                   f"({sum(map(len, g_tok))} tokens), page table, page use "
                   f"and all {n_pool} B of latent pages and rings bit for "
                   f"bit; {g_st.eager_steps} eager (= flushing) steps, "
                   f"{g_st.graph_replays} replayed; graphs "
                   f"{g_st.tokens_per_s:.2f} tok/s, TTFT mean "
                   f"{g_st.ttft_mean_s * 1e3:.1f} ms, inter-token "
                   f"{g_st.inter_token_mean_s * 1e3:.2f} ms; eager "
                   f"{e_st.tokens_per_s:.2f} tok/s, inter-token "
                   f"{e_st.inter_token_mean_s * 1e3:.2f} ms | {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    tok = hybrid_prefill_slots(cfg, g_eng, 1000, seed=3)
    prof = profile_decode(cfg, g_eng, tok, "decode_moe_mla")
    log("moe_mla", f"{cfg.name} decode step, 4 slots at ~1000 tokens, from "
                   f"the graph: host {prof['graph']['host_ms']:.3f} ms/step, "
                   f"device busy {prof['graph']['busy_ms']:.3f} ms/step, "
                   f"{prof['graph']['tok_s']:.1f} tok/s | {smi}")
    del g_eng
    gc.collect()
    torch.cuda.empty_cache()

    # the fixed loop: 4 x 1000 tokens (one joint MoE dispatch of the 4000
    # prompt tokens), graph == eager byte for byte
    prompts = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 1000)), dtype=torch.int32, device="cuda")
    launches["decode_attend"] += fixed_graphs(cfg, run, params, prompts,
                                              1000 + 40 + blk, 40, smi)[0]
    gc.collect()
    torch.cuda.empty_cache()

    # disaggregated: 1 prefill -> 1 decode replica over the loopback
    dis = DisaggEngine(cfg, run, params=params, **kw)
    ops.reset_launch_counts()
    res, dst = dis.run(reqs)
    torch.cuda.synchronize()
    for n_, c_ in ops.launch_counts().items():
        launches[n_] += c_ if n_ in SERVE_KERNELS else 0
    assert [r.tokens for r in res] == g_tok, "disagg streams != monolithic"
    assert dst.n_transfers == len(reqs)
    log("moe_mla", f"disagg 1 prefill -> 1 decode (loopback): the monolithic "
                   f"streams bit for bit; {dst.n_transfers} handoffs of "
                   f"latent pages ({cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim}"
                   f" wide); wire {dst.wire_bytes} B of {dst.wire_raw_bytes} "
                   f"B raw (link_reduction {dst.link_reduction:.4f}); "
                   f"{dst.tokens_per_s:.2f} tok/s, TTFT mean "
                   f"{dst.ttft_mean_s * 1e3:.1f} ms, transfer "
                   f"{dst.transfer_mean_s * 1e3:.1f} ms a handoff | {smi}")
    del dis
    gc.collect()
    torch.cuda.empty_cache()

    # the packed weight plane: both weight kernels on every one of
    # deepseek's packed leaves (partial column tiles: N 64 and 576), then
    # the serve mix's first 3 requests from CUDA graphs; ``unpack`` must
    # give the raw streams, ``cuda``'s divergences must be near-ties
    t0 = time.perf_counter()
    packed = weights.pack_serving_params(params, backend="cuda")
    torch.cuda.synchronize()
    p_bytes = weights.weight_plane_bytes(packed)
    b_ = packed["blocks"]
    assert isinstance(b_["moe"]["w_gate"], weights.PackedWeight)
    assert not isinstance(b_["attn"]["kv_norm"], weights.PackedWeight)
    log("moe_mla", f"packed on the card in {time.perf_counter() - t0:.1f}s: "
                   f"{p_bytes[0]} B of {p_bytes[1]} B raw "
                   f"({p_bytes[0] / p_bytes[1]:.3f}); expert stacks "
                   f"{tuple(b_['moe']['w_gate'].shape)} at k="
                   f"{b_['moe']['w_gate'].k}; device memory "
                   f"{torch.cuda.memory_allocated() >> 20} MiB")
    packed_leaf_checks(cfg, params, packed, gen, "moe_mla")
    raw3 = g_tok[:3]
    for be in ("unpack", "cuda"):
        run_be = RunConfig(codec=dataclasses.replace(run.codec,
                                                     weight_backend=be))
        eng = ServeEngine(cfg, run_be, params=packed, compress_weights=True,
                          prefix_sharing=False, **kw)
        ops.reset_launch_counts()
        res, st = eng.run(reqs[:3])
        torch.cuda.synchronize()
        pl = ops.launch_counts()
        got = [r.tokens for r in res]
        if be == "unpack":
            assert got == raw3, "unpack backend: streams != raw"
            assert pl["lexi_unpack"] > 0 and pl["decompress_matmul"] == 0
            log("moe_mla", f"packed weights (unpack backend), first 3 "
                           f"requests from CUDA graphs: the raw run's "
                           f"streams; {st.tokens_per_s:.2f} tok/s | {smi}")
            del eng
            continue
        for name in ("decompress_matmul", "lexi_unpack"):
            assert pl[name] > 0, pl
            launches[name] += pl[name]
        same = sum(a == b for r, g in zip(got, raw3) for a, b in zip(r, g))
        log("moe_mla", f"packed weights (cuda backend), first 3 requests "
                       f"from CUDA graphs: {st.weight_bytes_per_step} B per "
                       f"step of {st.weight_raw_bytes_per_step} B raw "
                       f"({st.weight_ratio:.3f}); {same}/"
                       f"{sum(map(len, got))} tokens equal to the raw run; "
                       f"{st.tokens_per_s:.2f} tok/s; launches "
                       f"decompress_matmul {pl['decompress_matmul']}, "
                       f"lexi_unpack {pl['lexi_unpack']} | {smi}")
        for uid, (ra, rb) in enumerate(zip(raw3, got)):
            i = next((j for j, (a, b) in enumerate(zip(ra, rb)) if a != b),
                     None)
            if i is None:
                continue
            prompt = torch.as_tensor(reqs[uid].prompt, dtype=torch.int32,
                                     device="cuda")[None]
            forced = torch.as_tensor([ra[:i]], dtype=torch.int32,
                                     device="cuda")
            side = [teacher_forced(cfg, run, w, prompt, prompt.shape[1],
                                   forced, 8 * blk)[i][0]
                    for w in (params, packed)]
            m_raw, m_cuda, gap = logit_margins(*side)
            log("moe_mla", f"raw vs cuda, request {uid} position {i}: top-2 "
                           f"margin raw {m_raw:.4g} / cuda {m_cuda:.4g}, "
                           f"largest logit gap {gap:.4g}")
            assert min(m_raw, m_cuda) <= gap, "packed: margin above the gap"
        tok = hybrid_prefill_slots(cfg, eng, 1000, seed=3)
        prof = profile_decode(cfg, eng, tok, "decode_moe_mla_packed")
        log("moe_mla", f"{cfg.name} packed (cuda) decode step, 4 slots at "
                       f"~1000 tokens, from the graph: host "
                       f"{prof['graph']['host_ms']:.3f} ms/step, device busy "
                       f"{prof['graph']['busy_ms']:.3f} ms/step | {smi}")
        del eng
    del packed, params
    gc.collect()
    torch.cuda.empty_cache()

    # jamba-tiny-dev: the serve mix from graphs against eager
    reqs = serve_mix(jamba, np.random.default_rng(0))
    g_eng, g_tok, g_st, g_l, n_pool, n_ssm, e_st = serve_graph_eager(
        jamba, run, engine_params(jamba), reqs, kw)
    for n in SERVE_KERNELS:
        launches[n] += g_l[n]
    log("moe_mla", f"{jamba.name} ({jamba.n_layers} layers, d="
                   f"{jamba.d_model}, {jamba.n_heads}/{jamba.n_kv_heads} "
                   f"heads of {jamba.head_dim}, SSM d_state "
                   f"{jamba.ssm.d_state}, {jamba.moe.n_experts} experts top-"
                   f"{jamba.moe.top_k}; {jamba.param_count()} parameters) "
                   f"serve mix from CUDA graphs: the eager run's streams "
                   f"({sum(map(len, g_tok))} tokens), page table, page use, "
                   f"all {n_pool} B of pages and rings and all {n_ssm} B of "
                   f"SSM state bit for bit; {g_st.eager_steps} eager (= "
                   f"flushing) steps, {g_st.graph_replays} replayed; "
                   f"{g_st.tokens_per_s:.2f} tok/s (eager "
                   f"{e_st.tokens_per_s:.2f}) | {smi}")
    del g_eng
    gc.collect()
    torch.cuda.empty_cache()
    log("moe_mla", f"phase done in {time.perf_counter() - t_phase:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 13: tensor parallelism, two ranks on the one card
# ---------------------------------------------------------------------------

TP_BLK = 256
# prompts of whole trunks (power-of-two multiples of tp: no replayed
# tail), so the phase's decode steps are few: two ranks on one card run
# every collective through host memory (see ``tp_phase``)
TP_MIX = ((512, 4), (256, 3), (1024, 3), (512, 3), (256, 2), (512, 4))
TP_FIXED = (4, 508, 6)         # fixed loop: B, prompt, steps (flush at 510)


def tp_mix(cfg):
    """The tp phase's requests: 6 prompts of 256 .. 1024 tokens over 4
    slots, from seed 1."""
    import numpy as np
    rng = np.random.default_rng(1)
    return [dict(uid=i, prompt=rng.integers(0, cfg.vocab_size, (s,))
                 .astype(np.int32), max_new_tokens=b)
            for i, (s, b) in enumerate(TP_MIX)]


def tp_fixed_prompts(cfg):
    import numpy as np
    b, s, _ = TP_FIXED
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s)) \
        .astype(np.int32)


def tp_teacher_forced(cfg, run, params, reqs, streams, tg=None):
    """``tp_jobs.paged_forced`` on the card under a ``RunProbe``: each
    request's prompt trunk (a multiple of tp: at tp = 1, and for the
    dense mix's even prompts, the whole prompt) prefilled into a slot of
    its own, its tail and ``streams[i][:-1]`` fed through masked paged
    decode steps.  Returns the whole-vocab logits (len(streams[i]), Vp)
    that predict each stream position, the compressed collectives' wire
    and raw bytes of each prefill (this rank's parts) and the prefill
    and decode clock."""
    import torch
    from repro_torch.launch import tp_jobs

    with RunProbe() as probe:
        out = tp_jobs.paged_forced(tg, cfg, run, params,
                                   [r["prompt"] for r in reqs], streams,
                                   "cuda")
    wires = [tuple(sum(v[f] for v in pf["kinds"].values())
                   for f in ("wire_bytes", "raw_bytes"))
             for pf in probe.prefills]
    clock = dict(prefill_s=sum(pf["ms"] for pf in probe.prefills) / 1e3,
                 prefills=len(probe.prefills),
                 decode_s=sum(probe.steps) / 1e3, steps=len(probe.steps))
    return [torch.from_numpy(x) for x in out], wires, clock


def forced_as_served(cfg, run, params, reqs, feeds, tg=None, slots=4):
    """``tp_teacher_forced`` of ``reqs`` fed ``feeds`` in groups of the
    served engine's ``slots``, each group padded with copies of its first
    request: every decode step then has the served run's rows (the
    decode route's split-K plan and the GEMMs depend on the rows), so a
    path forced with a served stream reproduces that run's numbers.
    Returns the logits of ``reqs`` only."""
    out = []
    for i in range(0, len(reqs), slots):
        r, f = list(reqs[i:i + slots]), list(feeds[i:i + slots])
        n = len(r)
        r += [r[0]] * (slots - n)
        f += [f[0]] * (slots - n)
        out += tp_teacher_forced(cfg, run, params, r, f, tg)[0][:n]
    return out


def tp_fixed_forced(cfg, run, params, prompts, tokens, max_len, tg=None,
                    extras=None):
    """The fixed loop (``engine.prefill`` + ``engine.decode_step``, with
    the stub inputs ``extras``) with ``tokens`` (B, T) fed in place of its
    own greedy picks: the whole-vocab logits (B, T, Vp) that predict each
    of them (at tp > 1 the ranks' vocab shards gathered)."""
    import torch
    from repro_torch.core import collectives as cl
    from repro_torch.serve import engine

    feed = torch.as_tensor(tokens, dtype=torch.int32, device="cuda")
    logits, st = engine.prefill(cfg, run, params, prompts, max_len, tg,
                                **(extras or {}))
    rows = [cl.all_gather(logits[:, -1], tg, axis=-1)]
    for j in range(feed.shape[1] - 1):
        logits = engine.decode_step(cfg, run, params, st, feed[:, j:j + 1],
                                    tg)
        rows.append(cl.all_gather(logits[:, -1], tg, axis=-1))
    return torch.stack(rows, 1).float().cpu()


HANDOFF_SPANS = ("export", "wire_chunk", "wire", "import")


def disagg_fleet(cfg, run, params, reqs, tg=None):
    """A ``DisaggEngine`` fleet (one prefill and one decode replica of 4
    slots, loopback transport, streaming on; at tp > 1 every rank its
    shard, ``group=tg``) on ``reqs``, from ``params`` (the monolithic
    engine's), traced: its streams, stats, wall time, launches and each
    handoff span's host ms (``HANDOFF_SPANS``: the blob's export, the
    streamed chunks, the closing blob's transfer, the import)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.disagg import DisaggEngine
    from repro_torch.serve.scheduler import Request
    from repro_torch.serve.telemetry import Tracer

    tr = Tracer(True)
    fleet = DisaggEngine(cfg, run, group=tg, n_slots=4,
                         max_len=4 * TP_BLK * 2, params=params,
                         streaming=True, tracer=tr, device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results, st = fleet.run([Request(**r) for r in reqs])
    torch.cuda.synchronize()
    out = dict(streams=[list(r.tokens) for r in results],
               wall_s=time.perf_counter() - t0,
               launches=ops.launch_counts(),
               stats=dict(st.__dict__, link_reduction=st.link_reduction),
               spans={k: [e["dur"] / 1e6 for e in tr.events
                          if e["name"] == k] for k in HANDOFF_SPANS})
    del fleet
    torch.cuda.empty_cache()
    return out


def disagg_line(d) -> str:
    """A fleet's link bytes and handoff times (``disagg_fleet``)."""
    st, sp = d["stats"], d["spans"]
    n = max(st["n_transfers"], 1)
    per = ", ".join(f"{k} {sum(v) / n:.1f} ms" for k, v in sp.items())
    return (f"{st['n_transfers']} transfers: wire {st['wire_bytes']} B "
            f"against {st['wire_raw_bytes']} B raw bf16 (link_reduction "
            f"{st['link_reduction']:.4f}; {st['pages_streamed']} pages "
            f"streamed in {st['stream_chunk_bytes']} B); host ms per "
            f"handoff: {per}; wall {d['wall_s']:.2f}s, "
            f"{st['tokens_per_s']:.2f} tok/s; launches {d['launches']}")


def tp_disagg_fleet(tg, cfg, run, eng, reqs, mono):
    """The tp phase's fleet at tp = 2 (``disagg_fleet`` on ``eng``'s
    weights) against ``eng``'s monolithic streams ``mono`` of the same
    mix: at each request's first divergence, its common prefix
    teacher-forced through the paged path (``tp_teacher_forced``) and the
    top-2 margin there returned for the parent's near-tie check."""
    out = disagg_fleet(cfg, run, eng.params, reqs, tg)
    out["ties"] = []
    for a, b, r in zip(out["streams"], mono, reqs):
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        logits = forced_as_served(cfg, run, eng.params, [r], [b[:j + 1]],
                                  tg)
        m, _, _ = logit_margins(logits[0][j, :cfg.vocab_size],
                                logits[0][j, :cfg.vocab_size])
        out["ties"].append((r["uid"], j, a[j], b[j], m))
    return out


def tp_rank_job(tg, cfg, want_streams, want_fixed):
    """One rank of the tp phase (spawned; ``tg`` its gloo TPGroup on the
    card): qwen3-4b at tp = 2 from seed 0 (the tp = 1 weights padded, this
    rank's shard), the mix served raw and packed (``cuda`` weight
    backend), both weight kernels on this rank's packed shards
    (``packed_leaf_checks``), the fixed loop, the tp = 1 streams
    teacher-forced through the raw and the packed paged path and the
    fixed loop, and the compressed all-gather timed against a raw one on
    this transport."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import collectives as cl
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    run = RunConfig(codec=CodecConfig(cache_block=TP_BLK))
    reqs = tp_mix(cfg)
    res = {}
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, run, group=tg, n_slots=4,
                      max_len=4 * TP_BLK * tg.world, seed=0, device="cuda")
    res["init_s"] = time.perf_counter() - t0
    for name, e in (("raw", eng), ("packed", None)):
        if e is None:
            t0 = time.perf_counter()
            e = ServeEngine(cfg, dataclasses.replace(
                run, codec=dataclasses.replace(run.codec,
                                               weight_backend="cuda")),
                group=tg, n_slots=4,
                max_len=4 * TP_BLK * tg.world, params=eng.params,
                compress_weights=True, device="cuda")
            torch.cuda.synchronize()
            res["pack_s"] = time.perf_counter() - t0
        cl.wire.reset()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results, st = e.run([Request(**r) for r in reqs])
        torch.cuda.synchronize()
        res[name] = dict(streams=[list(r.tokens) for r in results],
                         wall_s=time.perf_counter() - t0,
                         steps=st.decode_steps,
                         launches=ops.launch_counts(),
                         wire=cl.wire.snapshot(),
                         tok_s=st.tokens_per_s,
                         weight_bytes=st.weight_bytes_per_step,
                         weight_raw=st.weight_raw_bytes_per_step)
        if name == "packed":
            ops.reset_launch_counts()
            forced, _, _ = tp_teacher_forced(cfg, e.run_cfg, e.params, reqs,
                                             want_streams, tg)
            res["forced_packed"] = [x.numpy() for x in forced]
            res["forced_packed_launches"] = ops.launch_counts()
            gen = torch.Generator(device="cuda").manual_seed(13 + tg.rank)
            res["leaf_errs"] = packed_leaf_checks(
                cfg, eng.params, e.params, gen, f"tp rank {tg.rank}",
                tp=tg.world, stacks=True)
            del e
    res["disagg"] = tp_disagg_fleet(tg, cfg, run, eng, reqs,
                                    res["raw"]["streams"])
    # the fixed loop (engine.prefill + decode_step), eager at tp > 1
    b, s, n = TP_FIXED
    prompts = torch.as_tensor(tp_fixed_prompts(cfg), device="cuda")
    max_len = s + n + TP_BLK * tg.world
    ops.reset_launch_counts()
    cl.wire.reset()
    t0 = time.perf_counter()
    toks = engine.generate(cfg, run, eng.params, prompts, n, max_len, tg)
    torch.cuda.synchronize()
    res["fixed"] = dict(tokens=toks.cpu().numpy(), launches=ops.launch_counts(),
                        wall_s=time.perf_counter() - t0,
                        wire=cl.wire.snapshot())
    res["fixed_forced"] = tp_fixed_forced(cfg, run, eng.params, prompts,
                                          want_fixed, max_len, tg).numpy()
    # the tp = 1 streams teacher-forced through this path
    cl.wire.reset()
    logits, wires, clock = tp_teacher_forced(cfg, run, eng.params, reqs,
                                             want_streams, tg)
    res["forced"] = [x.numpy() for x in logits]
    res["prefill_wire"] = wires
    res["clock"] = clock
    res["overflows"] = cl.wire.overflows
    res["parts"] = cl.wire.parts
    # compress + gather + decompress against a raw all-gather of the same
    # activation (a 512-token prefill's normed input, this rank's half)
    gen = torch.Generator(device="cuda").manual_seed(3)
    h = (torch.randn((1, 256, cfg.d_model), generator=gen, device="cuda")
         * 0.5).to(torch.bfloat16)
    same = torch.equal(cl.compressed_all_gather(h, tg, run.codec,
                                                gather_axis=1),
                       cl.all_gather(h, tg, axis=1))
    timing = {}
    for label, fn in (("compressed", lambda: cl.compressed_all_gather(
            h, tg, run.codec, gather_axis=1)),
                      ("raw", lambda: cl.all_gather(h, tg, axis=1))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        timing[label] = (time.perf_counter() - t0) / 20 * 1e3
    ct = cl._compress(h, run.codec)
    t0 = time.perf_counter()
    for _ in range(20):
        cl.pack_wire(cl._compress(h, run.codec))
    torch.cuda.synchronize()
    timing["compress"] = (time.perf_counter() - t0) / 20 * 1e3
    res["gather_ms"] = dict(timing, same=same, shape=list(h.shape),
                            wire_bytes=ct.wire_bytes(),
                            raw_bytes=h.numel() * 2)
    return res


# tp = 2's logits may differ from tp = 1's by at most this many times the
# tp = 1 reorder gap: the largest teacher-forced logit difference between
# tp = 1's raw weights and its packed ones (``cuda`` weight backend: the
# same products, their f32 sums in another order), read in the same run on
# the same prompts and tokens.  tp = 2 changes the rounding of each
# row-parallel product (each rank's partial rounded to bf16, then summed)
# where the packed weights change its summation order: either moves a
# product by about one bf16 unit in the last place, and the model's layers
# amplify both alike.  A wrong shard, merge or sum moves the logits by
# their own size instead.
TP_GAP_FACTOR = 4.0


def tp_held_to_tp1(label, cfg, got, want, forced2, forced1, bound):
    """tp = 2 against tp = 1 on sequences whose tp = 1 streams ``want``
    were teacher-forced through both (``forced2`` / ``forced1``: per
    sequence, the logits that predict each position): every sequence's
    largest logit gap within ``bound``, and at each sequence's first
    divergence of ``got`` from ``want`` a near-tie (a top-2 margin of
    either within that sequence's gap).  Logs each divergence; returns
    (tokens equal, tokens, largest gap)."""
    import numpy as np
    import torch

    v = cfg.vocab_size
    same = n_tok = 0
    top = 0.0
    for i, (g_, w) in enumerate(zip(got, want)):
        g_, w = list(g_), list(w)
        a = torch.as_tensor(np.asarray(forced2[i]))[:, :v]
        b_ = torch.as_tensor(np.asarray(forced1[i]))[:, :v]
        assert a.shape == b_.shape == (len(w), v), (label, i, a.shape)
        gap = float((a - b_).abs().max())
        top = max(top, gap)
        assert gap <= bound, (label, i, gap, bound)
        same += sum(int(x == y) for x, y in zip(g_, w))
        n_tok += len(w)
        diff = [j for j, (x, y) in enumerate(zip(g_, w)) if x != y]
        if not diff:
            continue
        j = diff[0]
        m2, m1, _ = logit_margins(a[j], b_[j])
        tie = min(m1, m2) <= gap
        log("tp", f"{label} {i} first divergence at token {j} (tp 2 "
                  f"{g_[j]}, tp 1 {w[j]}): teacher-forced top-2 margin tp 2"
                  f" {m2:.4g} / tp 1 {m1:.4g}, its largest logit gap "
                  f"{gap:.4g} (bound {bound:.4g}): "
                  f"{'near-tie' if tie else 'MARGIN ABOVE THE GAP'}")
        assert tie, (label, i, j, m1, m2, gap)
    return same, n_tok, top


def tp_phase(cfg, smi):
    """Tensor parallelism on the card: full-width qwen3-4b (main() passes
    its first ``PREFIX_LAYERS`` layers) at tp = 2 as two
    ranks (``launch.mesh.spawn``) on the one card, joined over gloo --
    NCCL refuses two ranks on one device, so the activations' packed wire
    buffers cross host memory: a check of function, not of link speed.
    The parent serves the mix and the fixed loop at tp = 1 from the same
    weights first, and teacher-forces those streams through its raw and
    its packed weights: their largest logit gap is the reorder gap that
    bounds tp = 2's (``TP_GAP_FACTOR``).  Both ranks must emit the same
    streams (raw, packed, fixed); each rank's packed shards go through both
    weight kernels against their plain versions; against tp = 1 (raw and
    packed paged paths, the fixed loop) every teacher-forced logit gap is
    within the bound and the streams part only at near-ties.  Prints the
    activation gathers' wire bytes per prefill against raw bf16, the
    escape overflows, the compressed gather's time against a raw gather,
    and the launches.  Returns rank 0's launches of the served runs and
    the fixed loop."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.launch import mesh
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import Request, ServeEngine

    t_phase = time.perf_counter()
    log("tp", f"{cfg.name} at tp = 2: two ranks on {torch.cuda.device_count()}"
              f" card(s) over gloo (one device: NCCL refuses two ranks on "
              f"one device), CUDA tensors staged through host memory | "
              f"{smi}")
    run = RunConfig(codec=CodecConfig(cache_block=TP_BLK))
    reqs = tp_mix(cfg)
    eng = ServeEngine(cfg, run, n_slots=4, max_len=4 * TP_BLK * 2, seed=0,
                      device="cuda")
    results, st1 = eng.run([Request(**r) for r in reqs])
    want = [list(r.tokens) for r in results]
    b, s, n = TP_FIXED
    prompts = torch.as_tensor(tp_fixed_prompts(cfg), device="cuda")
    max_len = s + n + TP_BLK
    want_fixed = engine.generate(cfg, run, eng.params, prompts, n,
                                 max_len).cpu().numpy()
    forced1, _, clock1 = tp_teacher_forced(cfg, run, eng.params, reqs, want)
    fixed1 = tp_fixed_forced(cfg, run, eng.params, prompts, want_fixed,
                             max_len).numpy()
    pk = ServeEngine(cfg, dataclasses.replace(run, codec=dataclasses.replace(
        run.codec, weight_backend="cuda")), n_slots=4, max_len=4 * TP_BLK * 2,
        params=eng.params, compress_weights=True, device="cuda")
    forced1_pk, _, _ = tp_teacher_forced(cfg, pk.run_cfg, pk.params, reqs,
                                         want)
    fixed1_pk = tp_fixed_forced(cfg, pk.run_cfg, pk.params, prompts,
                                want_fixed, max_len).numpy()
    fleet1 = disagg_fleet(cfg, run, eng.params, reqs)
    same1 = sum(x == y for a, b_ in zip(fleet1["streams"], want)
                for x, y in zip(a, b_))
    v = cfg.vocab_size
    gap1 = max([float((a[:, :v] - b_[:, :v]).abs().max())
                for a, b_ in zip(forced1, forced1_pk)]
               + [float(np.abs(fixed1[..., :v] - fixed1_pk[..., :v]).max())])
    assert 0 < gap1 < float("inf"), gap1
    bound = TP_GAP_FACTOR * gap1
    log("tp", f"tp = 1 reference: mix {st1.tokens_per_s:.1f} tok/s, fixed "
              f"loop {b} x {s} + {n}; its streams teacher-forced through its "
              f"raw and its packed (cuda) weights: largest logit gap "
              f"{gap1:.6g} (the reorder gap), so tp = 2 is held within "
              f"{TP_GAP_FACTOR:g} x {gap1:.6g} = {bound:.6g} "
              f"({time.perf_counter() - t_phase:.1f}s) | {smi}")
    log("tp", f"tp = 1 fleet (1 prefill -> 1 decode replica, streaming) "
              f"on the same mix: {same1}/{sum(map(len, want))} tokens "
              f"equal to the monolithic tp = 1 engine's; "
              f"{disagg_line(fleet1)} | {smi}")
    del eng, pk, results
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = mesh.spawn(tp_rank_job, 2, backend="gloo", device="cuda",
                       args=(cfg, want, want_fixed))
    log("tp", f"2 ranks done in {time.perf_counter() - t0:.1f}s (rank 0: "
              f"engine with seeded weights {ranks[0]['init_s']:.1f}s, the "
              f"packed engine {ranks[0]['pack_s']:.1f}s) | {smi}")
    r0, r1 = ranks
    for key in ("raw", "packed"):
        assert r0[key]["streams"] == r1[key]["streams"], key
    assert np.array_equal(r0["fixed"]["tokens"], r1["fixed"]["tokens"])
    for key in ("raw", "packed"):
        got = r0[key]["streams"]
        for i, rq in enumerate(reqs):
            assert len(got[i]) == rq["max_new_tokens"], (key, i)
            assert all(0 <= t < cfg.vocab_size for t in got[i])
    shard_shapes = [k for k, _ in weight_shapes(cfg, 2)]
    for rank, r in enumerate(ranks):
        errs = r["leaf_errs"]
        log("tp", f"rank {rank}: decompress_matmul at its packed shards' "
                  f"(K, N) {shard_shapes} within 1e-4*(|x|@|W|)+1e-6 of "
                  f"the plain version, worst max |err| at M=4 "
                  f"{errs[4]:.3e}, at M=1024 {errs[1024]:.3e}; lexi_unpack "
                  f"exact on every stacked shard")

    # tp = 2 against tp = 1: gaps bounded, first divergences near-ties
    rows = [("raw uid", r0["raw"]["streams"], want, r0["forced"], forced1),
            ("packed uid", r0["packed"]["streams"], want,
             r0["forced_packed"], forced1),
            ("fixed seq", r0["fixed"]["tokens"], want_fixed,
             r0["fixed_forced"], fixed1)]
    for label, got, w, f2, f1 in rows:
        same, n_tok, gap = tp_held_to_tp1(label, cfg, got, w, f2, f1, bound)
        log("tp", f"{label.split()[0]}: tp 2 == tp 1 on {same}/{n_tok} "
                  f"tokens; teacher-forced logit gap tp 2 vs tp 1 max "
                  f"{gap:.6g} (bound {bound:.6g}, {gap / gap1:.3g} x the "
                  f"reorder gap)")
    n_dm = r0["forced_packed_launches"]["decompress_matmul"]
    assert n_dm > 0, r0["forced_packed_launches"]
    pk_raw = max(float(np.abs(a - b_).max())
                 for a, b_ in zip(r0["forced_packed"], r0["forced"]))
    log("tp", f"tp 2 packed vs tp 2 raw, the same teacher-forced tokens: "
              f"largest logit gap {pk_raw:.6g} ({n_dm} decompress_matmul "
              f"launches in the packed run)")
    log("tp", "streams: both ranks equal (raw, packed, fixed)")
    for key in ("raw", "packed"):
        r = r0[key]
        log("tp", f"{key}: {r['tok_s']:.2f} tok/s (wall {r['wall_s']:.2f}s "
                  f"for {r['steps']} decode steps, gloo through host), "
                  f"weights {r['weight_bytes']} B / {r['weight_raw']} B raw "
                  f"per rank and step, compressed gathers {r['wire']}, "
                  f"launches {r['launches']} | {smi}")
    # the disaggregated fleet at tp = 2 against the monolithic tp = 2
    d0, d1 = r0["disagg"], r1["disagg"]
    assert d0["streams"] == d1["streams"]
    assert d0["stats"]["wire_bytes"] == d1["stats"]["wire_bytes"]
    for uid, j, tok_f, tok_m, margin in d0["ties"]:
        tie = margin <= bound
        log("tp", f"disagg tp 2 vs monolithic tp 2, request {uid} first "
                  f"divergence at token {j} (fleet {tok_f}, monolithic "
                  f"{tok_m}): top-2 margin there {margin:.4g} (the reorder "
                  f"bound {bound:.4g}): "
                  f"{'near-tie' if tie else 'MARGIN ABOVE THE BOUND'}")
        assert tie, (uid, j, margin, bound)
    same = sum(x == y for a, b_ in zip(d0["streams"], r0["raw"]["streams"])
               for x, y in zip(a, b_))
    lr1, lr2 = (fleet1["stats"]["link_reduction"],
                d0["stats"]["link_reduction"])
    log("tp", f"disagg fleet at tp = 2 (1 prefill -> 1 decode replica, "
              f"streaming, each rank's pages in the blob): both ranks' "
              f"streams equal; {same}/{sum(map(len, d0['streams']))} "
              f"tokens equal to the monolithic tp = 2 engine's; "
              f"{disagg_line(d0)}; link_reduction tp 2 {lr2:.4f} vs tp 1 "
              f"{lr1:.4f} on the same prompts (wire/raw {1 - lr2:.4f} vs "
              f"{1 - lr1:.4f}) | {smi}")
    f = r0["fixed"]
    log("tp", f"fixed loop {b} x {s} + {n} steps: {f['wall_s']:.2f}s, "
              f"launches {f['launches']}, gathers {f['wire']} | {smi}")
    for i, ((wb, rb), rq) in enumerate(zip(r0["prefill_wire"], reqs)):
        log("tp", f"prefill of {len(rq['prompt'])} tokens: activation "
                  f"gathers put {wb} B on the wire for {rb} B of raw bf16 "
                  f"({rb / max(wb, 1):.4f}x) on rank 0 "
                  f"(rank 1: {r1['prefill_wire'][i][0]} B)")
    for name, c in (("tp 2 (rank 0, gloo through host)", r0["clock"]),
                    ("tp 1 (eager)", clock1)):
        log("tp", f"{name}: {c['prefill_s'] / c['prefills'] * 1e3:.1f} ms "
                  f"per one-sequence prefill of 256-1024 tokens (mean of "
                  f"{c['prefills']}), {c['decode_s'] / c['steps'] * 1e3:.1f}"
                  f" ms per teacher-forced decode step of the {len(reqs)} "
                  f"slots, those with tokens left (mean of {c['steps']}) | "
                  f"{smi}")
    gm = r0["gather_ms"]
    log("tp", f"escape overflows in the activation gathers: "
              f"{r0['overflows']} of {r0['parts']} parts (rank 0), "
              f"{r1['overflows']} of {r1['parts']} (rank 1)")
    log("tp", f"all-gather of {gm['shape']} bf16 per rank over gloo "
              f"(host-staged, one card): compress + gather + decompress "
              f"{gm['compressed']:.3f} ms ({gm['wire_bytes']} B on the "
              f"wire) vs raw {gm['raw']:.3f} ms ({gm['raw_bytes']} B); "
              f"compress alone {gm['compress']:.3f} ms; results equal: "
              f"{gm['same']} | {smi}")
    assert gm["same"]
    for key in ("decode_attend_paged", "exp_histogram", "lexi_pack",
                "lexi_unpack"):
        assert r0["raw"]["launches"][key] > 0, (key, r0["raw"]["launches"])
    assert r0["packed"]["launches"]["decompress_matmul"] > 0
    assert r0["fixed"]["launches"]["decode_attend"] > 0
    log("tp", f"phase done in {time.perf_counter() - t_phase:.1f}s | {smi}")
    launches = dict(r0["raw"]["launches"])
    for part in (r0["packed"]["launches"], f["launches"], d0["launches"]):
        for k_, v_ in part.items():
            launches[k_] += v_
    return launches


# ---------------------------------------------------------------------------
# phase 14: the paper's hybrids at tp = 2 (expert-parallel MoE over the
# compressed all-to-all, column-sharded Mamba2 heads), two ranks on the card
# ---------------------------------------------------------------------------

TPH_ARCHS = ("jamba-tiny-dev", "zamba2-1.2b", MLA_TP_ARCH)
# depth cuts for the time limit (width kept): zamba2-1.2b runs its first
# 8 of 26 layers here (as the hybrid phase does at tp = 1), deepseek its
# first TPM_LAYERS of 27 (at most the moe_mla phase's MOE_MLA_LAYERS)
TPM_LAYERS = 4
TPH_LAYERS = {"zamba2-1.2b": 8, MLA_TP_ARCH: TPM_LAYERS}
TPH_BLK = 256
# 4 prompts of 255 .. 1023 tokens, 3 odd (their one-token tails replay
# through decode steps at tp = 2), 16 new tokens each, over 4 slots
TPH_MIX = ((512, 16), (255, 16), (1023, 16), (385, 16))
# deepseek's mix at tp = 2: 4 prompts of 255 .. 767 tokens, 2 odd, 6 new
# tokens each (its MoE layers' all-to-alls cross host memory twice a
# layer and step)
TPM_MIX = ((512, 6), (255, 6), (767, 6), (384, 6))
TPH_MAXLEN = 4 * TPH_BLK * 2
TPH_FIXED = (4, 508, 6)        # jamba's fixed loop: B, prompt, steps


def cut_cfg(name, depths):
    """``name``'s config at the depth ``depths`` gives it (its own
    otherwise), width kept."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg, n_layers=depths.get(name, cfg.n_layers))


def tph_cfg(name):
    """``name``'s config at the tp_hybrid phase's depth (TPH_LAYERS)."""
    return cut_cfg(name, TPH_LAYERS)


def tph_mix(cfg):
    """The phase's requests from seed 1 (TPM_MIX for MLA, else
    TPH_MIX)."""
    import numpy as np
    rng = np.random.default_rng(1)
    mix = TPM_MIX if cfg.mla is not None else TPH_MIX
    return [dict(uid=i, prompt=rng.integers(0, cfg.vocab_size, (s,))
                 .astype(np.int32), max_new_tokens=b)
            for i, (s, b) in enumerate(mix)]


def tiny_jamba_cfg():
    """The tests' jamba-like model: the tiny hybrid with a MoE FFN (8
    experts of 64, top-2) in place of its MLP."""
    from repro_torch.configs.base import MoEConfig
    return dataclasses.replace(
        tiny_hybrid_cfg(), name="jl", d_ff=0,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64))


class RunProbe:
    """Inside ``with``: every ``engine.prefill_sequences`` (an admission's
    batched prefill) and every ``engine.PagedDecoder.forward`` (a decode or
    replay step) of this process timed between two device syncs, each
    prefill with the compressed collectives' counts by kind
    (``collectives.wire.kinds``) it added."""

    def __enter__(self):
        import torch
        from repro_torch.core import collectives as cl
        from repro_torch.serve import engine

        self.prefills, self.steps = [], []
        self._saved = (engine.prefill_sequences, engine.PagedDecoder.forward)
        pf, fw = self._saved

        def prefill(cfg, run, params, tokens, tg=None):
            torch.cuda.synchronize()
            before, t0 = cl.wire.snapshot()["kinds"], time.perf_counter()
            out = pf(cfg, run, params, tokens, tg)
            torch.cuda.synchronize()
            kinds = {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
                     for k, v in cl.wire.kinds.items()}
            self.prefills.append(dict(
                shape=tuple(tokens.shape), kinds=kinds,
                ms=(time.perf_counter() - t0) * 1e3))
            return out

        def forward(dec, params, active=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fw(dec, params, active)
            torch.cuda.synchronize()
            self.steps.append((time.perf_counter() - t0) * 1e3)
            return out

        engine.prefill_sequences = prefill
        engine.PagedDecoder.forward = forward
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import engine
        engine.prefill_sequences, engine.PagedDecoder.forward = self._saved
        return False


def tph_model(tg, cfg, gen):
    """One model of the tp_hybrid phase on this rank: the mix served raw
    (prefix sharing as the engine decides: on for a hybrid without MoE)
    and packed (``cuda`` weight backend), each under a ``RunProbe`` with
    its launches and compressed collectives counted, then, with prefix
    sharing, request 0 again (a snapshot hit); both weight kernels
    on this rank's packed shards (``packed_leaf_checks``); each request
    whose packed stream parts from the raw one teacher-forced through both
    weight stores up to its first divergence (``forced_as_served``); a MoE
    model's fixed loop."""
    import dataclasses as dc
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import collectives as cl
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import Request, ServeEngine

    run = RunConfig(codec=CodecConfig(cache_block=TPH_BLK))
    reqs = tph_mix(cfg)
    out = {}
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, run, group=tg, n_slots=4, max_len=TPH_MAXLEN,
                      seed=0, device="cuda")
    out["init_s"] = time.perf_counter() - t0
    pk = None
    for label in ("raw", "packed"):
        e = eng
        if label == "packed":
            t0 = time.perf_counter()
            pk = e = ServeEngine(cfg, dc.replace(run, codec=dc.replace(
                run.codec, weight_backend="cuda")), group=tg, n_slots=4,
                max_len=TPH_MAXLEN, params=eng.params,
                compress_weights=True, device="cuda")
            torch.cuda.synchronize()
            out["pack_s"] = time.perf_counter() - t0
        cl.wire.reset()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with RunProbe() as probe:
            results, st = e.run([Request(**r) for r in reqs])
        torch.cuda.synchronize()
        out[label] = dict(
            streams=[list(r.tokens) for r in results],
            wall_s=time.perf_counter() - t0, steps=st.decode_steps,
            admits=st.n_admit_dispatches, replays=st.n_replay_dispatches,
            tok_s=st.tokens_per_s, weight_bytes=st.weight_bytes_per_step,
            weight_raw=st.weight_raw_bytes_per_step,
            launches=ops.launch_counts(), kinds=cl.wire.snapshot()["kinds"],
            prefills=probe.prefills, step_ms=probe.steps)
        if e.prefix_sharing:
            # request 0's page-aligned prompt again, in a later admission
            # (two in one cold batch would both prefill): a snapshot hit
            again, st2 = e.run([Request(**dict(reqs[0], uid=len(reqs)))])
            out[label].update(again=list(again[0].tokens),
                              hits=st2.shared_page_hits,
                              again_admits=st2.n_admit_dispatches)
    out["leaf_errs"] = packed_leaf_checks(
        cfg, eng.params, pk.params, gen, f"tp_hybrid rank {tg.rank}",
        tp=tg.world)
    # packed against raw: each request's first divergence teacher-forced
    # through both weight stores
    parts = []
    for r, a, b in zip(reqs, out["raw"]["streams"],
                       out["packed"]["streams"]):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            parts.append((r, j, a[:j + 1]))
    out["ties"] = []
    if parts:
        preqs, _, fed = zip(*parts)
        sides = [forced_as_served(cfg, e.run_cfg, e.params, preqs, fed, tg)
                 for e in (eng, pk)]
        for (r, j, _), lr, lp in zip(parts, *sides):
            m_raw, m_pk, gap = logit_margins(lr[-1, :cfg.vocab_size],
                                             lp[-1, :cfg.vocab_size])
            out["ties"].append((r["uid"], j, m_raw, m_pk, gap))
    del pk
    if cfg.moe is not None:             # the fixed loop, eager at tp > 1
        import numpy as np
        b, s, n = TPH_FIXED
        prompts = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (b, s)), dtype=torch.int32, device="cuda")
        ops.reset_launch_counts()
        cl.wire.reset()
        t0 = time.perf_counter()
        toks = engine.generate(cfg, run, eng.params, prompts, n,
                               s + n + TPH_BLK * tg.world, tg)
        torch.cuda.synchronize()
        out["fixed"] = dict(tokens=toks.cpu().numpy(),
                            wall_s=time.perf_counter() - t0,
                            launches=ops.launch_counts(),
                            kinds=cl.wire.snapshot()["kinds"])
    return out


def tp_hybrid_rank_job(tg):
    """One rank of the tp_hybrid phase (spawned; ``tg`` its gloo TPGroup
    on the card): the tiny jamba-like model on the card against the CPU
    at tp = 2, raw and packed; then each of TPH_ARCHS at full width and
    depth from seed 0 (the tp = 1 weights, this rank's shard)."""
    import gc
    import torch
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    res = dict(tiny={})
    t0 = time.perf_counter()
    for packed in (False, True):
        ops.reset_launch_counts()
        res["tiny"][packed] = (small_model_diff(packed, tiny_jamba_cfg(), tg),
                               ops.launch_counts())
    res["tiny_s"] = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(17 + tg.rank)
    for name in TPH_ARCHS:
        t0 = time.perf_counter()
        res[name] = tph_model(tg, tph_cfg(name), gen)
        res[name]["model_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return res


def tph_kind_line(kinds) -> str:
    """'kind: wire B for raw B (ratio), overflows' for each kind."""
    return "; ".join(
        f"{k} {v['wire_bytes']} B for {v['raw_bytes']} B raw "
        f"({v['raw_bytes'] / max(v['wire_bytes'], 1):.4f}x, {v['parts']} "
        f"parts, {v['overflows']} overflows)" for k, v in sorted(kinds.items()))


def tp_hybrid_phase(smi):
    """The paper's hybrids at tp = 2 on the card: two ranks
    (``launch.mesh.spawn``) on the one card over gloo, host-staged, from
    seed 0's weights (each rank's tp = 2 shard of the tp = 1 tree).  The
    tiny jamba-like model's logits on the card within 1e-2 of the same two
    ranks on the CPU (prefill + 10 decode steps, raw and packed); then
    jamba-tiny-dev (8 layers: attention ∥ Mamba2, 8 experts top-2 over the
    compressed all-to-all) and zamba2-1.2b (its first 8 of 26 layers,
    ``TPH_LAYERS``: attention ∥ Mamba2, its 64 SSM heads split 32 a rank)
    at full width: the mix
    (``tph_mix``) raw and packed, zamba2's with prefix sharing on and its
    page-aligned 512-token prompt served again after the mix (a snapshot
    hit on both ranks, no prefill, the same stream);
    jamba's fixed loop.  Both ranks' streams equal; packed against raw,
    each first divergence a near-tie (a top-2 margin within the two
    stores' logit gap there); each rank's packed shards through both
    weight kernels.  Prints, for each prefill, the all-to-all's dispatch
    and return and the activation gathers' wire bytes against raw bf16
    with their escape overflows (0 for the all-to-alls), ms per prefill
    and per decode step, and the launches.  tp = 1 is no yardstick here:
    the reference's SSM and MoE compute another function at tp = 2
    (ROADMAP.md, section 3).  Returns rank 0's launches."""
    import collections
    import torch
    from repro_torch.launch import mesh

    t_phase = time.perf_counter()
    log("tp_hybrid", f"{', '.join(TPH_ARCHS)} at tp = 2: two ranks on "
                     f"{torch.cuda.device_count()} card(s) over gloo, CUDA "
                     f"tensors staged through host memory | {smi}")
    ranks = mesh.spawn(tp_hybrid_rank_job, 2, backend="gloo", device="cuda")
    r0, r1 = ranks
    launches = collections.Counter()
    for packed in (False, True):
        for rank, r in enumerate(ranks):
            worst, lc = r["tiny"][packed]
            log("tp_hybrid", f"tiny jamba-like model (3 layers, attention "
                             f"∥ Mamba2, 8 experts top-2) at tp = 2, "
                             f"{'packed' if packed else 'raw'} weights, "
                             f"rank {rank}: card vs CPU logits max |diff| "
                             f"{worst:.2e} (<= 1e-2), prefill + 10 steps; "
                             f"decompress_matmul launches "
                             f"{lc['decompress_matmul']}")
            assert (lc["decompress_matmul"] > 0) == packed, lc
    for name in TPH_ARCHS:
        cfg = tph_cfg(name)
        a, b = r0[name], r1[name]
        reqs = tph_mix(cfg)
        for key in ("raw", "packed"):
            assert a[key]["streams"] == b[key]["streams"], (name, key)
            for req, toks in zip(reqs, a[key]["streams"]):
                assert len(toks) == req["max_new_tokens"], (name, key)
                assert all(0 <= t < cfg.vocab_size for t in toks)
            assert a[key]["replays"] > 0, (name, key)     # odd tails
            for k_, v_ in a[key]["launches"].items():
                launches[k_] += v_
            for n_ in ("decode_attend_paged", "exp_histogram", "lexi_pack",
                       "lexi_unpack"):
                assert a[key]["launches"][n_] > 0, (name, key, n_)
        assert a["packed"]["launches"]["decompress_matmul"] > 0
        same = sum(x == y for s1, s2 in zip(a["raw"]["streams"],
                                            a["packed"]["streams"])
                   for x, y in zip(s1, s2))
        n_tok = sum(map(len, a["raw"]["streams"]))
        log("tp_hybrid", f"{name} ({cfg.n_layers} layers, d {cfg.d_model}, "
                         f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
                         f"{cfg.head_dim}"
                         + (f", SSM {cfg.ssm.n_heads(cfg.d_model)} heads x "
                            f"{cfg.ssm.headdim}, d_state {cfg.ssm.d_state}"
                            if cfg.ssm else "")
                         + (f", MLA latent {cfg.mla.kv_lora_rank} + "
                            f"{cfg.mla.qk_rope_dim}, each rank "
                            f"{cfg.padded_heads(2) // 2} of the "
                            f"{cfg.n_heads} heads, w_dkv row-parallel"
                            if cfg.mla else "")
                         + (f", {cfg.moe.n_experts} experts top-"
                            f"{cfg.moe.top_k}" if cfg.moe else "")
                         + f"): both ranks' streams equal, raw and packed; "
                         f"packed == raw on {same}/{n_tok} tokens; rank 0 "
                         f"engine {a['init_s']:.1f}s, packing "
                         f"{a['pack_s']:.1f}s, model {a['model_s']:.1f}s")
        for uid, j, m_raw, m_pk, gap in a["ties"]:
            tie = min(m_raw, m_pk) <= gap
            log("tp_hybrid", f"{name} packed vs raw, request {uid} first "
                             f"divergence at token {j}: top-2 margin raw "
                             f"{m_raw:.4g} / packed {m_pk:.4g}, largest "
                             f"logit gap {gap:.4g}: "
                             f"{'near-tie' if tie else 'MARGIN ABOVE THE GAP'}")
            assert tie, (name, uid, j, m_raw, m_pk, gap)
        for rank, r in enumerate(ranks):
            errs = r[name]["leaf_errs"]
            log("tp_hybrid", f"{name} rank {rank}: decompress_matmul at "
                             f"its packed shards' (K, N) "
                             f"{[k_ for k_, _ in weight_shapes(cfg, 2)]} "
                             f"within 1e-4*(|x|@|W|)+1e-6, worst max |err| "
                             f"at M=4 {errs[4]:.3e}, at M=1024 "
                             f"{errs[1024]:.3e}; lexi_unpack exact on the "
                             f"raw-read leaves and expert stacks")
        if cfg.moe is None and cfg.mla is None:
            for key in ("raw", "packed"):
                for rank, r in enumerate(ranks):
                    assert r[name][key]["hits"] > 0, (name, key, rank)
                    assert r[name][key]["again_admits"] == 0
                assert a[key]["again"] == a[key]["streams"][0], key
                log("tp_hybrid", f"{name} {key}, prefix sharing: request "
                                 f"0's page-aligned "
                                 f"{len(reqs[0]['prompt'])}-token prompt "
                                 f"served again is a boundary-snapshot hit "
                                 f"on both ranks ({a[key]['hits']} / "
                                 f"{b[key]['hits']} columns, no prefill), "
                                 f"its stream equal to the first's")
        for key in ("raw", "packed"):
            r = a[key]
            log("tp_hybrid", f"{name} {key}: {r['tok_s']:.2f} tok/s (wall "
                             f"{r['wall_s']:.2f}s, {r['steps']} decode "
                             f"steps, {r['admits']} admissions, "
                             f"{r['replays']} replay windows), weights "
                             f"{r['weight_bytes']} B / {r['weight_raw']} B "
                             f"raw per rank and step; compressed "
                             f"collectives: {tph_kind_line(r['kinds'])}; "
                             f"launches {r['launches']} | {smi}")
            for pf in r["prefills"]:
                log("tp_hybrid", f"{name} {key} prefill {pf['shape']} "
                                 f"(rank 0): {pf['ms']:.1f} ms; "
                                 f"{tph_kind_line(pf['kinds'])}")
            ms = r["step_ms"]
            log("tp_hybrid", f"{name} {key}: {sum(ms) / len(ms):.1f} ms per "
                             f"decode or replay step (mean of {len(ms)}, "
                             f"median {sorted(ms)[len(ms) // 2]:.1f}) | "
                             f"{smi}")
            for k_ in ("dispatch", "return"):
                if k_ in r["kinds"]:
                    assert r["kinds"][k_]["overflows"] == 0, (name, key, k_)
                    assert b[key]["kinds"][k_]["overflows"] == 0
        if cfg.moe is not None:
            assert "dispatch" in a["raw"]["kinds"]
            f = a["fixed"]
            assert (f["tokens"] == b["fixed"]["tokens"]).all()
            assert f["launches"]["decode_attend"] > 0, f["launches"]
            for k_, v_ in f["launches"].items():
                launches[k_] += v_
            bb, ss, nn = TPH_FIXED
            log("tp_hybrid", f"{name} fixed loop {bb} x {ss} + {nn} steps: "
                             f"both ranks' tokens equal, {f['wall_s']:.2f}s, "
                             f"launches {f['launches']}, "
                             f"{tph_kind_line(f['kinds'])} | {smi}")
    log("tp_hybrid", f"phase done in {time.perf_counter() - t_phase:.1f}s "
                     f"| {smi}")
    return launches


# ---------------------------------------------------------------------------
# phase 15: training (the dense family at mesh 2x1: FSDP with compressed
# weight gathers and gradient sync; at mesh 1x2: sequence-parallel blocks
# with compressed activation gathers and the vocab-parallel loss, and the
# fsdp tp_strategy)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1.5-1.8b"
TRAIN_SHAPE = (4, 512, 2)        # global batch, sequence, 2x1 steps
TRAIN_LAYERS = 4                 # of qwen1.5-1.8b's 24, width kept
TRAIN_TP_STEPS = 2               # megatron steps at mesh 1x2 (fsdp: 1)
# 2x1 and fsdp 1x2 against 1x1 at step 0: the codec is lossless and the
# blocks run unsharded, so only the order of the sums differs (the
# gradient's reduce-scatter, the loss over ranks)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GNORM_RTOL = 1e-2
# megatron 1x2 against 1x1 at step 0: the blocks' tp path sums its
# row-parallel partials in another order (bf16 reduce-scatters)
TRAIN_TP_LOSS_RTOL = 1e-3
TRAIN_KERNELS = ("exp_histogram", "lexi_pack", "lexi_unpack")
TRAIN_ACT = (4, 256, 2048)       # one rank's activation gather at 1x2


def train_job(tg, cfg, steps: int, model: int = 1,
              strategy: str = "megatron"):
    """One run of the train phase on this rank (``tg`` None: the 1x1 run
    in this process): ``launch.train.train_loop`` of full-width ``cfg``
    from seed 0 for ``steps`` steps at mesh (world / model) x model under
    ``strategy``, with the compressed collectives' wire bytes by kind
    (``fsdp`` weight gathers, ``all_gather`` activation gathers, the
    ``loss`` gather, the ``grads`` sync), the codec kernels' launches
    during the run and the peak device memory."""
    import torch
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.core import collectives as cl
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, _ = TRAIN_SHAPE
    world = 1 if tg is None else tg.world
    cl.wire.reset()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = launch_train.train_loop(
        cfg, ShapeConfig("train", s, b, "train"),
        MeshConfig(world // model, model, 1),
        RunConfig(codec=CodecConfig(), remat=True, warmup_steps=1,
                  tp_strategy=strategy),
        steps=steps,
        ckpt_dir=None, ckpt_every=0, resume=False, log=lambda *_: None,
        tg=tg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = dict(history=out["history"], wall_s=wall,
               kinds=cl.wire.snapshot()["kinds"],
               launches=ops.launch_counts(),
               peak=torch.cuda.max_memory_allocated(),
               device=str(torch.cuda.get_device_name()))
    torch.cuda.empty_cache()
    return res


def train_rank_job(tg, cfg):
    """A rank of the train phase's one spawn: mesh 2x1 (TRAIN_SHAPE's
    steps), then mesh 1x2 under the megatron strategy (TRAIN_TP_STEPS)
    and under the fsdp strategy (its step 0)."""
    return [train_job(tg, cfg, TRAIN_SHAPE[2]),
            train_job(tg, cfg, TRAIN_TP_STEPS, model=2),
            train_job(tg, cfg, 1, model=2, strategy="fsdp")]


def train_state_bytes(cfg, data: int, model: int = 1,
                      strategy: str = "megatron") -> int:
    """A rank's bytes of state at mesh data x model: bf16 params and
    grads, f32 master, m and v, each leaf the rank's shard."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import tree
    from repro_torch.models import lm, params as PM
    sizes = {"data": data, "model": model}
    n = 0
    for d in tree.leaves(lm.lm_table(cfg, tp=model, data=data,
                                     run=RunConfig(tp_strategy=strategy))):
        n += math.prod(d.shape) // math.prod(
            sizes[a] for a in PM.spec_axes(d))
    return n * (2 + 2 + 4 * 3)


def kind_line(kinds, names) -> str:
    """Wire / raw bytes, calls and escape overflows of some kinds."""
    return "; ".join(
        f"{k} {kinds[k]['wire_bytes']} B for {kinds[k]['raw_bytes']} B raw "
        f"({kinds[k]['raw_bytes'] / kinds[k]['wire_bytes']:.4f}x, "
        f"{kinds[k]['calls']} calls, overflows {kinds[k]['overflows']})"
        for k in names if k in kinds)


def train_codec_kernels(cfg, smi, per_step):
    """exp_histogram and lexi_pack bit for bit against their plain
    versions, and lexi_unpack's round trip exact, at the train path's
    largest shards (one compress group each): the embedding's FSDP shard
    and the largest block leaf's per-layer shard at 2x1, and one rank's
    activation gather at 1x2 (TRAIN_ACT, N(0, 1) like the normed
    activations; rows 2a, 3a, 5a, beside ``per_step``: their launches per
    1x2 step); each timed against its bound and its plain version (the
    histogram also against a ``torch.bincount``)."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import entropy as E
    from repro_torch.core import fixed, tree
    from repro_torch.kernels import lexi_unpack, ops, ref
    from repro_torch.models import lm

    table = lm.lm_table(cfg, data=2, run=RunConfig())
    emb = table["embed"]
    shard = tuple(s // 2 if i == emb.fsdp_dim else s
                  for i, s in enumerate(emb.shape))
    blk = max((d for d in tree.leaves(table["blocks"])
               if d.fsdp_dim is not None), key=lambda d: math.prod(d.shape))
    bshard = tuple(s // 2 if i == blk.fsdp_dim else s
                   for i, s in enumerate(blk.shape))[1:]
    gen = torch.Generator(device="cuda").manual_seed(24)
    k = RunConfig().codec.k
    for name, shape, std in (("embed shard", shard, 0.02),
                             ("block shard", bshard, 0.02),
                             ("1x2 activation shard", TRAIN_ACT, 1.0)):
        n = math.prod(shape)
        x = (torch.randn((1, n), generator=gen, device="cuda") * std) \
            .to(torch.bfloat16)
        how = codec_check(name, x, k)
        t = codec_timing(x, k)
        c = max(n // 128, 8)
        ct = fixed.compress_many(x, k=k, esc_capacity=c)
        back = ops.unpack(ct)
        assert torch.equal(back.view(torch.int16), x.view(torch.int16)), name
        un = cuda_ms(lambda: ops.unpack_rows(ct.signman, ct.planes,
                                             ct.dict_syms, k))
        un_bound = (3 + k / 8) * n / HBM_BYTES_PER_S * 1e3
        esc = int(ct.n_escapes.max())
        # the plain versions' times, and a torch.bincount of the exponents
        # (extracted beforehand) as the histogram's yardstick
        lut = fixed.build_dictionary(ops.histogram(x), k)[1]
        keys = E.exponent(E.to_u16(x)).reshape(-1)
        plain = [cuda_ms(fn, reps=3, warmup=1) for fn in (
            lambda: ref.histogram_ref(x), lambda: ref.pack_ref(x, lut, k),
            lambda: lexi_unpack.plain(ct.signman, ct.planes, ct.dict_syms,
                                      k))]
        lib = cuda_ms(lambda: torch.bincount(keys, minlength=256))
        steps = (f"; launches per 1x2 step {per_step}" if "1x2" in name
                 else "")
        log("train", f"codec kernels at the {name} {shape} (1 x {n}, k={k}"
                     f"): exact against the plain versions ({how}); "
                     f"exp_histogram {t['exp_histogram']['ms']:.4f} ms "
                     f"(bound {t['exp_histogram']['bound_ms']:.4f}, plain "
                     f"{plain[0]:.3f}, torch.bincount {lib:.4f}), lexi_pack "
                     f"{t['lexi_pack']['ms']:.4f} ms (bound "
                     f"{t['lexi_pack']['bound_ms']:.4f}, plain "
                     f"{plain[1]:.3f}), lexi_unpack {un:.4f} ms (bound "
                     f"{un_bound:.4f}, plain {plain[2]:.3f}), round trip "
                     f"through compress_many -> ops.unpack exact ({esc} "
                     f"escapes, capacity {c}){steps} | {smi}")
        del x, ct, back, keys
        torch.cuda.empty_cache()


def train_ckpt_phase(smi):
    """Checkpoint and restart through ``launch.train.main`` at the reduced
    size (the LEXI-H coder is a Python loop per symbol): two ranks on the
    card, a failure injected at step 6, recovery from the step-4
    checkpoint to step 8; then the step-8 checkpoint restored and saved
    again to the same bytes, and its stored against raw bytes."""
    import shutil
    from repro_torch.configs import get_config, make_reduced
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import tree
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt

    d = ROOT / "build" / "train_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    assert launch_train.main([
        "--arch", TRAIN_ARCH, "--reduced", "--mesh", "2x1", "--steps", "8",
        "--batch", "4", "--seq", "64", "--ckpt-dir", str(d),
        "--ckpt-every", "4", "--simulate-failure", "6",
        "--dist-backend", "gloo"]) == 0
    assert ckpt.latest_step(str(d)) == 8, ckpt.latest_step(str(d))
    cfg = make_reduced(get_config(TRAIN_ARCH))
    like = launch_train.state_like(lm.lm_table(cfg, data=2,
                                               run=RunConfig()))
    st = ckpt.restore(str(d), like)
    again = ckpt.save(str(d / "again"), 8,
                      tree.map_(lambda x: x.to("cuda"), st))
    with open(Path(again) / "MANIFEST.json") as fh:
        files = [e["file"] for e in json.load(fh)["leaves"]]
    for f in files:
        assert (Path(again) / f).read_bytes() == \
            (d / "step_00000008" / f).read_bytes(), f
    sz = ckpt.stored_size(str(d), 8)
    log("train", f"checkpoint/restart ({cfg.name} reduced, 2 ranks, 8 "
                 f"steps, a failure at step 6): LATEST reads step 8; the "
                 f"step-8 checkpoint restored, moved to the card and saved "
                 f"again: all {len(files)} leaf files byte-identical (a "
                 f"restore -> save round trip, bit for bit); stored "
                 f"{sz['stored_bytes']} B against "
                 f"{sz['raw_bytes']} B raw "
                 f"({sz['raw_bytes'] / sz['stored_bytes']:.3f}x) "
                 f"({time.perf_counter() - t0:.1f}s) | {smi}")


def train_steps_lines(label, runs, smi):
    """Both ranks' steps of one run: equal loss and grad norm, each
    finite; one line a step."""
    r0, r1 = runs
    for h0, h1 in zip(r0["history"], r1["history"]):
        assert (h0["loss"], h0["grad_norm"]) == (h1["loss"], h1["grad_norm"])
        assert all(math.isfinite(h0[k]) for k in ("loss", "grad_norm"))
        log("train", f"{label} step {h0['step']}: loss {h0['loss']:.6f} "
                     f"grad norm {h0['grad_norm']:.6f} lr {h0['lr']:.3e} "
                     f"clip scale {h0['clip_scale']:.6f} | rank 0 "
                     f"{h0['ms']:.1f} ms, rank 1 {h1['ms']:.1f} ms (both "
                     f"ranks' loss and grad norm equal) | {smi}")


def train_phase(smi):
    """Training on the card: full-width qwen1.5-1.8b (its first
    TRAIN_LAYERS of 24 layers, seed 0) through ``launch.train.train_loop``
    -- two ranks on the one card over gloo (host-staged; NCCL refuses two
    ranks on one device), global batch 4 x 512, codec full, remat on --
    in one spawn: at mesh 2x1 (FSDP) for TRAIN_SHAPE's steps, at mesh 1x2
    under the megatron strategy (sequence-parallel blocks, the
    vocab-parallel loss) for TRAIN_TP_STEPS and under the fsdp strategy
    for its step 0.  Per step loss, grad norm, lr, clip scale and ms,
    both ranks equal; the compressed collectives' wire bytes against raw
    bf16 by kind, with their escape overflows (0); each rank's peak
    device memory against its state; the codec kernels' launches during
    each run (each > 0).  Then step 0 at mesh 1x1 in this process from
    the same seed and batch: 2x1's loss within TRAIN_LOSS_RTOL and grad
    norm within TRAIN_GNORM_RTOL of it, megatron 1x2's within
    TRAIN_TP_LOSS_RTOL and TRAIN_GNORM_RTOL, fsdp 1x2's loss within
    TRAIN_LOSS_RTOL.  Then the codec kernels at the train path's shapes
    (``train_codec_kernels``) and the reduced checkpoint/restart
    (``train_ckpt_phase``).  Returns rank 0's launches during the three
    spawned runs."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    b, s, steps = TRAIN_SHAPE
    state = {m: train_state_bytes(cfg, *m) for m in ((2, 1), (1, 2),
                                                     (1, 2, "fsdp"))}
    log("train", f"{cfg.name} full width ({cfg.n_layers} of "
                 f"{get_config(TRAIN_ARCH).n_layers} layers, d "
                 f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
                 f"vocab {cfg.vocab_size}: {cfg.padded_vocab(1)} rows at tp "
                 f"1, {cfg.padded_vocab(2)} at tp 2) in one spawn of two "
                 f"ranks on {torch.cuda.device_count()} card(s) over gloo, "
                 f"CUDA tensors staged through host memory; global batch {b}"
                 f" x {s}, codec full, remat on: mesh 2x1 {steps} steps, "
                 f"mesh 1x2 megatron {TRAIN_TP_STEPS} steps, mesh 1x2 fsdp "
                 f"1 step; predicted state per rank "
                 + ", ".join(f"{'x'.join(map(str, m[:2]))}"
                             f"{' fsdp' if len(m) > 2 else ''} "
                             f"{v / 1e9:.2f} GB" for m, v in state.items())
                 + f" (bf16 params and grads, f32 master, m, v) | {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh.spawn(train_rank_job, 2, backend="gloo", device="cuda",
                       args=(cfg,))
    (d0, tp0, fs0), (d1, tp1, fs1) = ranks
    log("train", f"2 ranks done in {time.perf_counter() - t0:.1f}s (rank 0 "
                 f"train_loop 2x1 {d0['wall_s']:.1f}s, 1x2 megatron "
                 f"{tp0['wall_s']:.1f}s, 1x2 fsdp {fs0['wall_s']:.1f}s: "
                 f"seeded init on the card, then the steps) | {smi}")
    launches = {k: 0 for k in TRAIN_KERNELS}
    for label, key, runs in (("2x1", (2, 1), (d0, d1)),
                             ("1x2 megatron", (1, 2), (tp0, tp1)),
                             ("1x2 fsdp", (1, 2, "fsdp"), (fs0, fs1))):
        train_steps_lines(label, runs, smi)
        n_steps = len(runs[0]["history"])
        for r, res in enumerate(runs):
            kinds = res["kinds"]
            log("train", f"{label} rank {r} over {n_steps} step(s): "
                         + kind_line(kinds, ("fsdp", "all_gather", "loss",
                                             "grads"))
                         + f"; peak device memory {res['peak'] / 1e9:.2f} GB"
                         f" (state {state[key] / 1e9:.2f} GB + transients)"
                         f" | {smi}")
            assert all(v["overflows"] == 0 for v in kinds.values()), kinds
        want = {"2x1": {"fsdp", "grads"},
                "1x2 megatron": {"all_gather", "loss", "grads"},
                "1x2 fsdp": {"fsdp", "loss", "grads"}}[label]
        assert set(runs[0]["kinds"]) == want, (label, runs[0]["kinds"])
        got = {k: runs[0]["launches"][k] for k in TRAIN_KERNELS}
        log("train", f"{label}: codec kernel launches during the run: rank "
                     f"0 {got}, rank 1 "
                     f"{ {k: runs[1]['launches'][k] for k in TRAIN_KERNELS} }")
        assert all(v > 0 for v in got.values()), (label, got)
        for k in TRAIN_KERNELS:
            launches[k] += got[k]
    per_step = {k: tp0["launches"][k] // TRAIN_TP_STEPS
                for k in TRAIN_KERNELS}

    gc.collect()
    torch.cuda.empty_cache()
    solo = train_job(None, cfg, 1)
    h1 = solo["history"][0]
    for label, h2, ltol, gtol in (
            ("2x1", d0["history"][0], TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL),
            ("1x2 megatron", tp0["history"][0], TRAIN_TP_LOSS_RTOL,
             TRAIN_GNORM_RTOL),
            ("1x2 fsdp", fs0["history"][0], TRAIN_LOSS_RTOL, None)):
        dl = abs(h1["loss"] - h2["loss"]) / abs(h1["loss"])
        dg = abs(h1["grad_norm"] - h2["grad_norm"]) / abs(h1["grad_norm"])
        log("train", f"1x1 step 0 in this process: loss {h1['loss']:.6f} "
                     f"grad norm {h1['grad_norm']:.6f} {h1['ms']:.1f} ms; "
                     f"against {label}: loss rel gap {dl:.3e} (limit "
                     f"{ltol:g}), grad norm rel gap {dg:.3e} (limit "
                     f"{'none' if gtol is None else f'{gtol:g}'}); peak "
                     f"device memory {solo['peak'] / 1e9:.2f} GB; "
                     f"compressed collectives "
                     f"{sum(v['calls'] for v in solo['kinds'].values())} "
                     f"| {smi}")
        assert dl <= ltol and (gtol is None or dg <= gtol), (label, dl, dg)
    del solo
    gc.collect()
    torch.cuda.empty_cache()
    train_codec_kernels(cfg, smi, per_step)
    train_ckpt_phase(smi)
    log("train", f"phase done in {time.perf_counter() - t_phase:.1f}s | "
                 f"{smi}")
    return launches


# ---------------------------------------------------------------------------
# phase 16: the remaining families at tp = 1 (mamba2-370m, seamless,
# internvl2-76b, gemma2-9b, hymba-1.5b, granite-moe-1b-a400m)
# ---------------------------------------------------------------------------

FAM_BLK = 256
# depth cuts for the time limit (width kept): gemma2-9b runs all of its
# 42 layers, internvl2-76b 4 of its 80 (FAM_LAYERS), the others whole
FAM_LAYERS = {"internvl2-76b": 4}
FAM_NEW = 16               # new tokens of the fixed loops
ENC_LEN = 512              # seamless: encoder frames = decoder prompt
VLM_LEN = 512              # internvl2: prompt, its first 256 positions images
GEMMA_FIXED = (4, 4200)    # gemma2's fixed loop: B, prompt (past its window)


def fam_cfg(name):
    """``name``'s config at the families phase's depth (FAM_LAYERS)."""
    return cut_cfg(name, FAM_LAYERS)


def tiny_ssm_cfg():
    """The reference tests' attention-free model (2 layers, d 64)."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    return ModelConfig(name="s", family="ssm", n_layers=2, d_model=64,
                       n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=512,
                       ssm=SSMConfig(d_state=16, headdim=8, chunk=16),
                       sub_quadratic=True)


def tiny_stub_cfgs():
    """The reference tests' encoder-decoder and a tiny vision-stub VLM."""
    from repro_torch.configs.base import ModelConfig
    return (ModelConfig(name="e", family="encdec", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
                        head_dim=16, encdec=True, frontend="audio_stub"),
            ModelConfig(name="v", family="vlm", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                        head_dim=16, frontend="vision_stub",
                        n_frontend_tokens=8))


def small_fixed_diff(cfg) -> float:
    """Prefill + 10 teacher-forced fixed-loop steps of a tiny enc-dec or
    VLM on the card and on the CPU from the same weights, tokens and stub
    inputs (``launch.serve.stub_inputs``); returns the largest logit gap
    (<= 1e-2)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import lm, params as PM
    from repro_torch.serve import engine

    run = RunConfig(codec=CodecConfig(cache_block=4))
    params = PM.init_params(lm.lm_table(cfg),
                            torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 10)),
                             dtype=torch.int32)
    extras = stub_inputs(cfg, rng, 2, 10, "cpu")
    states, logits = {}, {}
    for dev in ("cpu", "cuda"):
        p = PM.to_device(params, dev)
        lg, st = engine.prefill(cfg, run, p, prompt.to(dev), 32,
                                **{k: v.to(dev) for k, v in extras.items()})
        states[dev], logits[dev] = (st, p), [lg.float().cpu()]
    feed = engine.greedy_token(logits["cpu"][0])
    for _ in range(10):                     # crosses two ring flushes
        for dev in ("cpu", "cuda"):
            st, p = states[dev]
            logits[dev].append(engine.decode_step(
                cfg, run, p, st, feed.to(dev)).float().cpu())
        feed = engine.greedy_token(logits["cpu"][-1])
    worst = 0.0
    for a, b in zip(logits["cpu"], logits["cuda"]):
        assert torch.isfinite(b).all()
        worst = max(worst, float((a - b).abs().max()))
    assert worst <= 1e-2, worst
    return worst


def graph_profile(cfg, eng, name: str):
    """8 decode steps of 4 fresh 990-token slots of an idle engine from
    its CUDA graph, profiled (``profile_window``;
    ``chiprun_out/profile_<name>.txt``): host ms a step, busy ms a step,
    tok/s.  The three windows (warm-up and capture, timed, profiled) end
    at 1014 tokens, before the ring flush at 1024, so every step is a
    replay."""
    from repro_torch.serve import engine

    tok = hybrid_prefill_slots(cfg, eng, 990, seed=3)
    dec = engine.PagedDecoder(cfg, eng.run_cfg, eng.state, True)
    return profile_window(name, lambda: dec.decode(eng.params, tok, 8).cpu(),
                          8, dec.counts)


def fixed_profile(cfg, run, params, st, name: str):
    """8 steps of a fixed-loop state (4 sequences) from a CUDA graph,
    profiled (``profile_window``)."""
    import torch
    from repro_torch.serve import engine

    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    dec = engine.FixedDecoder(cfg, run, params, st, tok, True)

    def window():
        for _ in range(8):
            dec.step()
        return dec.tok.cpu()

    return profile_window(name, window, 8, dec.counts)


def fam_line(tag, row, launches, smi):
    """A new kernel row's numbers on one line (PERF.md section 6)."""
    log("families", f"row {tag}: ms {row['ms']:.4f}, plain ms "
                    f"{row['plain_ms']:.4f}, SDPA ms "
                    f"{row['library_ms']:.4f}, bound ms "
                    f"{row['bound_ms']:.5f} ({row['bound_by']}), max |err| "
                    f"{row['max_abs_err']:.3e}, launches {launches} | {smi}")


def fam_serve(cfg, run, params, reqs, graphs=True):
    """``cfg``'s serve mix on ``ServeEngine`` (4 slots, sharing off): every
    budget met; returns (engine, streams, stats, launches)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import ServeEngine

    eng = ServeEngine(cfg, run, params=params, cuda_graphs=graphs,
                      prefix_sharing=False, n_slots=4, max_len=8 * FAM_BLK,
                      device="cuda")
    ops.reset_launch_counts()
    results, st = eng.run(reqs)
    torch.cuda.synchronize()
    for req, res in zip(reqs, results):
        assert len(res.tokens) == req.max_new_tokens, (req.uid, res)
        assert all(0 <= t < cfg.vocab_size for t in res.tokens)
    return eng, [r.tokens for r in results], st, ops.launch_counts()


def mamba2_family(gen, smi, launches):
    """mamba2-370m, all 48 layers: ``ServeEngine`` eagerly and from CUDA
    graphs (streams and SSM state equal; no pages), profiled; a
    ``DisaggEngine`` fleet (the monolithic streams; the handoff's wire
    bytes: the SSM state alone); the packed weight plane (``cuda``:
    both weight kernels on its leaves, its streams against raw, each
    first divergence a near-tie); the fixed loop, graph == eager."""
    import dataclasses as dc
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import weights
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.serve import DisaggEngine

    cfg = fam_cfg("mamba2-370m")
    run = RunConfig(codec=CodecConfig(cache_block=FAM_BLK))
    reqs = serve_mix(cfg, np.random.default_rng(0))
    params = engine_params(cfg)
    runs = {g: fam_serve(cfg, run, params, reqs, g) for g in (False, True)}
    (e_eng, e_tok, e_st, _), (g_eng, g_tok, g_st, g_l) = runs[False], \
        runs[True]
    assert g_tok == e_tok, "mamba2: graph streams != eager"
    assert g_eng.state.kv is None and g_st.peak_pages == 0
    n_ssm = same_ssm(e_eng.state.ssm, g_eng.state.ssm)
    assert g_st.graph_captures == 1 and g_st.eager_steps == 0, g_st
    assert g_st.graph_replays == g_st.decode_steps > 0, g_st
    assert not any(g_l[n] for n in SERVE_KERNELS), g_l
    slot_bytes = ssm_mod.state_nbytes(g_eng.state.ssm) // 4
    log("families", f"{cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
                    f"SSM d_inner {cfg.ssm.d_inner(cfg.d_model)}, d_state "
                    f"{cfg.ssm.d_state}, vocab {cfg.vocab_size}, no "
                    f"attention): the serve mix from CUDA graphs equals the "
                    f"eager run (streams, all {n_ssm} B of SSM state); no "
                    f"page (peak_pages 0), no attention or page-codec "
                    f"launch; {g_st.graph_replays} steps replayed, 0 eager; "
                    f"SSM state {slot_bytes} B a slot")
    for graphs, (_, _, st, _) in sorted(runs.items()):
        log("families", f"{cfg.name} serve mix, "
                        f"{'CUDA graphs' if graphs else 'eager'}: "
                        f"{st.tokens_per_s:.2f} tok/s, inter-token "
                        f"{st.inter_token_mean_s * 1e3:.2f} ms, TTFT mean "
                        f"{st.ttft_mean_s * 1e3:.1f} ms | {smi}")
    del runs, e_eng
    gc.collect()
    prof = graph_profile(cfg, g_eng, "decode_mamba2")
    log("families", f"{cfg.name} decode step, 4 slots at ~1000 tokens, "
                    f"from the graph (no flush): host "
                    f"{prof['host_ms']:.3f} ms/step, "
                    f"busy {prof['busy_ms']:.3f} ms/step "
                    f"({100 * prof['busy_ms'] / prof['host_ms']:.0f}%), "
                    f"{prof['tok_s']:.1f} tok/s | {smi}")
    del g_eng
    gc.collect()
    torch.cuda.empty_cache()

    # disaggregated: 1 prefill -> 1 decode replica over the loopback
    dis = DisaggEngine(cfg, run, params=params, n_slots=4,
                       max_len=8 * FAM_BLK, device="cuda")
    res, dst = dis.run(reqs)
    torch.cuda.synchronize()
    assert [r.tokens for r in res] == g_tok, "mamba2: disagg != monolithic"
    assert dst.n_transfers > 0 and dst.wire_raw_bytes > 0
    log("families", f"{cfg.name} disagg 1 prefill -> 1 decode (loopback): "
                    f"the monolithic streams; {dst.n_transfers} handoffs, "
                    f"wire {dst.wire_bytes} B "
                    f"({dst.wire_bytes // dst.n_transfers} B a handoff: the "
                    f"SSM state and the header, no page) "
                    f"of {dst.wire_raw_bytes} B raw; transfer "
                    f"{dst.transfer_mean_s * 1e3:.1f} ms a handoff | {smi}")
    del dis
    gc.collect()
    torch.cuda.empty_cache()

    # the packed weight plane: both weight kernels on mamba2's leaves, its
    # streams against raw (each first divergence a near-tie)
    packed = weights.pack_serving_params(params, backend="cuda")
    packed_leaf_checks(cfg, params, packed, gen, "families")
    run_be = RunConfig(codec=dc.replace(run.codec, weight_backend="cuda"))
    eng, got, st, pl = fam_serve(cfg, run_be, packed, reqs)
    del eng
    for name in ("decompress_matmul", "lexi_unpack"):
        assert pl[name] > 0, pl
        launches[name] += pl[name]
    same = sum(a == b for r, g in zip(got, g_tok) for a, b in zip(r, g))
    log("families", f"{cfg.name} packed (cuda backend) from CUDA graphs: "
                    f"{st.weight_bytes_per_step} B per step of "
                    f"{st.weight_raw_bytes_per_step} B raw "
                    f"({st.weight_ratio:.3f}); {same}/{sum(map(len, got))} "
                    f"tokens equal to the raw run; {st.tokens_per_s:.2f} "
                    f"tok/s; decompress_matmul {pl['decompress_matmul']}, "
                    f"lexi_unpack {pl['lexi_unpack']} launches | {smi}")
    for uid, (ra, rb) in enumerate(zip(g_tok, got)):
        i = next((j for j, (a, b) in enumerate(zip(ra, rb)) if a != b), None)
        if i is None:
            continue
        prompt = torch.as_tensor(reqs[uid].prompt, dtype=torch.int32,
                                 device="cuda")[None]
        forced = torch.as_tensor([ra[:i]], dtype=torch.int32, device="cuda")
        side = [teacher_forced(cfg, run, w, prompt, prompt.shape[1], forced,
                               8 * FAM_BLK)[i][0] for w in (params, packed)]
        m_raw, m_cuda, gap = logit_margins(*side)
        log("families", f"{cfg.name} raw vs cuda, request {uid} position "
                        f"{i}: top-2 margin raw {m_raw:.4g} / cuda "
                        f"{m_cuda:.4g}, largest logit gap {gap:.4g}")
        assert min(m_raw, m_cuda) <= gap, "packed: margin above the gap"
    del packed
    gc.collect()
    torch.cuda.empty_cache()

    # the fixed loop: 4 x 1000 tokens + 40 steps, graph == eager
    prompts = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 1000)), dtype=torch.int32, device="cuda")
    _, st, ms = fixed_graphs(cfg, run, params, prompts, 1000 + 40 + FAM_BLK,
                             40, smi, phase="families")
    log("families", f"{cfg.name} fixed loop: {ms:.3f} ms a step from the "
                    f"graph ({4 * 1e3 / ms:.1f} tok/s) | {smi}")
    del params, st
    gc.collect()
    torch.cuda.empty_cache()


def stub_family(name, gen, smi, launches, rows):
    """seamless-m4t-large-v2 (24 + 24 layers; 4 x ENC_LEN encoder frames
    and decoder prompts) or internvl2-76b (FAM_LAYERS; 4 x VLM_LEN
    prompts, their first 256 positions front embeds) on the fixed loop,
    FAM_NEW new tokens, graph == eager (cross-attention stores too),
    profiled; seamless's cross-attention store: stored against raw
    bytes."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.launch.serve import stub_inputs

    cfg = fam_cfg(name)
    s = ENC_LEN if cfg.encdec else VLM_LEN
    run = RunConfig(codec=CodecConfig(cache_block=FAM_BLK))
    params = engine_params(cfg)
    rng = np.random.default_rng(8)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, s)),
                              dtype=torch.int32, device="cuda")
    extras = stub_inputs(cfg, rng, 4, s, "cuda")
    max_len = s + FAM_NEW + 8 * 3 + FAM_BLK
    n_dec, st, ms = fixed_graphs(cfg, run, params, prompts, max_len,
                                 FAM_NEW, smi, extras, phase="families")
    launches["decode_attend"] += n_dec
    kinds = "self and cross attention" if cfg.encdec else "attention"
    log("families", f"{cfg.name} ({cfg.n_layers} layers"
                    f"{' + as many encoder layers' if cfg.encdec else ''}, d "
                    f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
                    f"{cfg.head_dim}, vocab {cfg.vocab_size}): fixed loop "
                    f"4 x {s} + {FAM_NEW}, {ms:.3f} ms a step from the graph "
                    f"({4 * 1e3 / ms:.1f} tok/s); decode_attend {n_dec} "
                    f"launches ({kinds}) | {smi}")
    if cfg.encdec:
        stored, raw = cross_store_bytes(st, FAM_BLK)
        rows["6x"]["launches"] = n_dec // 2
        log("families", f"{cfg.name} cross-attention store: {st.xlen} "
                        f"frames x 4 sequences x {cfg.n_layers} layers, "
                        f"{stored} B stored of {raw} B raw bf16 "
                        f"({raw / stored:.4f}x) | {smi}")
    else:
        rows["6v"]["launches"] = n_dec
    prof = fixed_profile(cfg, run, params, st, f"decode_fixed_{cfg.family}")
    log("families", f"{cfg.name} fixed loop from the graph, profiled: host "
                    f"{prof['host_ms']:.3f} ms/step, busy "
                    f"{prof['busy_ms']:.3f} ms/step "
                    f"({100 * prof['busy_ms'] / prof['host_ms']:.0f}%) | "
                    f"{smi}")
    del params, st, extras
    gc.collect()
    torch.cuda.empty_cache()


def cross_store_bytes(st, blk, tp=1, ti=0):
    """(stored, raw bf16) bytes of a fixed-loop state's cross-attention
    stores (every layer's), on shard ``ti`` of ``tp``: its interleaved
    rows of the memory, the full blocks compressed, the rest in the
    ring."""
    from repro_torch.models import cache as cache_mod

    rows = cache_mod.local_length(st.xlen, tp, ti)
    nfull = rows // blk
    stored = raw = 0
    for x in st.xkv:
        stored += sum(getattr(x, f)[:, :nfull].numel() for f in
                      ("signman", "dict_syms", "esc_raw")) \
            + 4 * sum(getattr(x, f)[:, :nfull].numel()
                      for f in ("planes", "esc_pos")) \
            + (rows - nfull * blk) * x.ring.shape[0] * x.ring.shape[2] * 2
        raw += rows * x.ring.shape[0] * x.ring.shape[2] * 2
    return stored, raw


def attention_family(name, smi, launches, rows):
    """gemma2-9b (serve mix from CUDA graphs, its prompts 259-1029 tokens
    so that the tails its power-of-two trunks leave are short, and the
    fixed loop past its window), hymba-1.5b and granite-moe-1b-a400m
    (serve mix from CUDA graphs), each profiled."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.collectives import CodecConfig

    cfg = fam_cfg(name)
    run = RunConfig(codec=CodecConfig(cache_block=FAM_BLK))
    params = engine_params(cfg)
    reqs = serve_mix(cfg, np.random.default_rng(0))
    if cfg.moe is None and cfg.ssm is None:
        # a dense model's trunk is a power of two: short tails to replay
        for req, n in zip(reqs, (1029, 512, 259, 520, 300, 640)):
            req.prompt = req.prompt[:n] if n <= len(req.prompt) else \
                np.resize(req.prompt, n)
    eng, toks, st, g_l = fam_serve(cfg, run, params, reqs)
    passes = check_graph_run(cfg, st, g_l)
    assert all(g_l[n] > 0 for n in SERVE_KERNELS), g_l
    for n in SERVE_KERNELS:
        launches[n] += g_l[n]
    tag = {"gemma2-9b": "1g", "hymba-1.5b": "1h"}.get(name)
    if tag:
        rows[tag]["launches"] = g_l["decode_attend_paged"]
    log("families", f"{cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
                    f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
                    f"{cfg.head_dim}, window {cfg.window}, softcap "
                    f"{cfg.attn_softcap}, vocab {cfg.vocab_size}): serve mix "
                    f"(6 requests, 4 slots) from CUDA graphs, every budget "
                    f"met; {st.graph_replays} replayed, {st.eager_steps} "
                    f"eager (flushing) steps, {st.n_admit_dispatches} "
                    f"admissions + {st.n_replay_dispatches} replay windows; "
                    f"decode_attend_paged {g_l['decode_attend_paged']} = "
                    f"{cfg.n_layers} x {passes}; {st.tokens_per_s:.2f} tok/s,"
                    f" inter-token {st.inter_token_mean_s * 1e3:.2f} ms | "
                    f"{smi}")
    prof = graph_profile(cfg, eng, f"decode_{cfg.family}_{cfg.n_layers}")
    log("families", f"{cfg.name} decode step, 4 slots at ~1000 tokens, "
                    f"from the graph (no flush): host "
                    f"{prof['host_ms']:.3f} ms/step, "
                    f"busy {prof['busy_ms']:.3f} ms/step "
                    f"({100 * prof['busy_ms'] / prof['host_ms']:.0f}%), "
                    f"{prof['tok_s']:.1f} tok/s | {smi}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if name == "gemma2-9b":
        b, s = GEMMA_FIXED
        prompts = torch.as_tensor(np.random.default_rng(9).integers(
            0, cfg.vocab_size, (b, s)), dtype=torch.int32, device="cuda")
        n_dec, st, ms = fixed_graphs(cfg, run, params, prompts,
                                     s + FAM_NEW + FAM_BLK, FAM_NEW, smi,
                                     phase="families")
        launches["decode_attend"] += n_dec
        rows["6g"]["launches"] = n_dec
        log("families", f"{cfg.name} fixed loop {b} x {s} + {FAM_NEW} (its "
                        f"even layers' 4096-token window in force): {ms:.3f}"
                        f" ms a step from the graph ({b * 1e3 / ms:.1f} "
                        f"tok/s) | {smi}")
        del st
    del params
    gc.collect()
    torch.cuda.empty_cache()


def families_phase(smi):
    """The remaining families at tp = 1, at full width (random N(0, 0.02)
    weights from seed 0, codec on, block 256, 4 slots; depth cuts in
    FAM_LAYERS): the new attention geometries' kernel rows (1g, 1h, 6g,
    6v, 6x: each within 1e-4 of its plain version at its split edges,
    timed beside SDPA and its bound); the tiny attention-free, enc-dec
    and VLM models on the card against the CPU (1e-2); mamba2-370m on
    every serving path (``mamba2_family``); seamless-m4t-large-v2 and
    internvl2-76b on the fixed loop (``stub_family``); gemma2-9b,
    hymba-1.5b and granite-moe-1b-a400m (``attention_family``).  Returns
    the launches of its runs (from CUDA graphs, replays counted)."""
    import torch
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(21)
    launches = {name: 0 for name in REPLACES}
    rows = {"1g": paged_attend_kernel(fam_cfg("gemma2-9b"), gen,
                                      "families", small=True)[0],
            "1h": paged_attend_kernel(fam_cfg("hymba-1.5b"), gen,
                                      "families", small=True)[0],
            "6g": fixed_attend_kernel(fam_cfg("gemma2-9b"), gen, "families"),
            "6v": fixed_attend_kernel(fam_cfg("internvl2-76b"), gen,
                                      "families"),
            "6x": fixed_attend_kernel(fam_cfg("seamless-m4t-large-v2"), gen,
                                      "families", host_length=True)}
    torch.cuda.empty_cache()
    for packed in (False, True):
        ops.reset_launch_counts()
        worst = small_model_diff(packed, tiny_ssm_cfg())
        assert (ops.launch_counts()["decompress_matmul"] > 0) == packed
        log("families", f"tiny attention-free model, "
                        f"{'packed' if packed else 'raw'} weights, prefill "
                        f"+ 10 teacher-forced steps: card vs CPU logits max "
                        f"|diff| {worst:.2e} (<= 1e-2)")
    for cfg in tiny_stub_cfgs():
        worst = small_fixed_diff(cfg)
        log("families", f"tiny {cfg.family} model, fixed loop with its stub "
                        f"inputs, prefill + 10 teacher-forced steps: card vs "
                        f"CPU logits max |diff| {worst:.2e} (<= 1e-2)")
    marks = [("kernels + tiny", time.perf_counter())]
    mamba2_family(gen, smi, launches)
    marks.append(("mamba2", time.perf_counter()))
    for name in ("seamless-m4t-large-v2", "internvl2-76b"):
        stub_family(name, gen, smi, launches, rows)
        marks.append((name, time.perf_counter()))
    for name in ("gemma2-9b", "hymba-1.5b", "granite-moe-1b-a400m"):
        attention_family(name, smi, launches, rows)
        marks.append((name, time.perf_counter()))
    for tag, row in rows.items():
        fam_line(tag, row, row.get("launches"), smi)
    t0 = t_phase
    log("families", "phase done in "
        f"{time.perf_counter() - t_phase:.1f}s (" + ", ".join(
            f"{n} {t - t_prev:.1f}s" for (n, t), t_prev in
            zip(marks, [t0] + [t for _, t in marks[:-1]])) + ")")
    return launches


# ---------------------------------------------------------------------------
# phase 17: the remaining families at tp = 2 (the encoder-decoder and the
# vision stub on the fixed loop, the attention-free model on every serving
# path), two ranks on the card
# ---------------------------------------------------------------------------

# depth cuts for the time limit (width kept): seamless-m4t-large-v2 runs 6
# of its 24 encoder and 24 decoder layers, internvl2-76b 4 of its 80 (as
# the families phase does), mamba2-370m 12 of its 48
TPF_LAYERS = {"seamless-m4t-large-v2": 6, "internvl2-76b": 4,
              "mamba2-370m": 12}
TPF_STUBS = ("seamless-m4t-large-v2", "internvl2-76b")
TPF_BLK = 256
# the stubs' fixed loops: B, prompt, decode steps.  seamless's encoder
# frames are its prompt (ENC_LEN: 256 rows of the memory a shard);
# internvl2's 256 front tokens span both shards of a 384-token prompt
TPF_FIXED = {"seamless-m4t-large-v2": (4, ENC_LEN, 8),
             "internvl2-76b": (4, 384, 8)}
# mamba2's mix: the fixed loop's 4 prompts of 512 tokens, then 2 odd ones
# (their one-token tails replay at tp = 2), 8 new tokens each, 4 slots
TPF_MIX = ((512, 8),) * 4 + ((255, 8), (385, 8))
TPF_MAXLEN = 4 * TPF_BLK * 2
# the kernel rows: (model, tag, global length, host-length launch):
# seamless's cross store of ENC_LEN frames, static (the host-length
# launch); internvl2's self store at the fixed loop's 1100 tokens
TPF_ROWS = (("seamless-m4t-large-v2", "6xt", ENC_LEN, True),
            ("internvl2-76b", "6vt", 1100, False))


def tpf_cfg(name):
    """``name``'s config at the tp_families phase's depth (TPF_LAYERS)."""
    return cut_cfg(name, TPF_LAYERS)


def tpf_inputs(cfg):
    """A stub family's fixed-loop prompts and stub inputs on the card,
    from seed 8 in the launcher's order (``launch.serve.stub_inputs``:
    the prompts first), the same on every rank."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import stub_inputs

    b, s, _ = TPF_FIXED[cfg.name]
    rng = np.random.default_rng(8)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                              dtype=torch.int32, device="cuda")
    return prompts, stub_inputs(cfg, rng, b, s, "cuda")


def tpf_mix(cfg):
    """mamba2's requests from seed 1 (TPF_MIX): the first four share a
    length, so the fixed loop serves their prompts too."""
    import numpy as np
    rng = np.random.default_rng(1)
    return [dict(uid=i, prompt=rng.integers(0, cfg.vocab_size, (s,))
                 .astype(np.int32), max_new_tokens=n)
            for i, (s, n) in enumerate(TPF_MIX)]


def stub_tp_kernels(gen):
    """decode_attend's tp shard path at the stub families' heads
    (seamless's cross store: 16/16 heads of 64; internvl2: 64/8 of 128):
    every shard of tp 2 and 4 at its split edges against the plain
    version (``attend_cases.tp_fixed_checks``: both launch forms, two
    launches bit for bit), then shard 0 of tp = 2 timed (rows 6xt over
    a cross store of ENC_LEN frames, host-length launch; 6vt).  Returns
    the rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attend_cases as AC

    rows = {}
    for name, tag, length, host in TPF_ROWS:
        cfg = get_config(name)
        g = attend_geom(cfg)
        t0 = time.perf_counter()
        err, n = AC.tp_fixed_checks(gen, g.h, g.hd, g.w, g.kw)
        assert err < 1e-4, (name, err)
        log("tp_families", f"tp shard path at {name}'s heads (H={g.h}/"
                           f"{g.hkv}, hd={g.hd}, W={g.w}), every shard of "
                           f"tp 2 and 4: decode_attend {n} calls (both "
                           f"launch forms) within 1e-4 of the plain "
                           f"version, each launched twice bit for bit; "
                           f"max |err| {err:.3e} "
                           f"({time.perf_counter() - t0:.1f}s)")
        rows[tag] = tp_fixed_row(cfg, gen, "tp_families", tag, length, host)
    return rows


def tpf_params(tg, cfg):
    """Seed 0's tp = 1 weights on the card, padded for tp and cut to this
    rank's shard (as ``launch.serve --tp`` makes them)."""
    import gc
    import torch
    from repro_torch.models import lm, params as PM

    full = PM.init_params(lm.lm_table(cfg), torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    out = PM.shard_params(PM.pad_for_tp(full, cfg, tg.world),
                          lm.lm_table(cfg, tg.world), tg.world, tg.rank)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tpf_stub(tg, cfg, want):
    """seamless or internvl2 on this rank: the fixed loop eagerly (its
    prefill and each decode step timed between device syncs), the
    prefill's compressed gathers by kind, the launches, an
    encoder-decoder's cross store bytes on this shard, and tp = 1's
    tokens ``want`` teacher-forced through this path."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import collectives as cl
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import engine

    run = RunConfig(codec=CodecConfig(cache_block=TPF_BLK))
    b, s, n = TPF_FIXED[cfg.name]
    prompts, extras = tpf_inputs(cfg)
    max_len = s + n + TPF_BLK * tg.world
    params = tpf_params(tg, cfg)
    ops.reset_launch_counts()
    cl.wire.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, st = engine.prefill(cfg, run, params, prompts, max_len, tg,
                                **extras)
    torch.cuda.synchronize()
    out = dict(prefill_ms=(time.perf_counter() - t0) * 1e3,
               kinds=cl.wire.snapshot()["kinds"], step_ms=[])
    dec = engine.FixedDecoder(cfg, run, params, st,
                              engine.greedy_token(logits, tg), False, tg)
    toks = [dec.tok.clone()]
    for _ in range(n):
        t0 = time.perf_counter()
        dec.step()
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        toks.append(dec.tok.clone())
    out.update(tokens=torch.cat(toks, 1).cpu().numpy(),
               launches=ops.launch_counts())
    if cfg.encdec:
        out["xstore"] = cross_store_bytes(st, TPF_BLK, tg.world, tg.rank)
    del st, dec
    out["forced"] = tp_fixed_forced(cfg, run, params, prompts, want,
                                    max_len, tg, extras).numpy()
    return out


def tpf_mamba2(tg, cfg):
    """mamba2 on this rank at tp = 2: ``ServeEngine(group=)`` (no pool)
    on the mix raw and packed (``cuda`` weight backend), each under a
    ``RunProbe``; the raw streams teacher-forced through both weight
    stores at the served slot count (``forced_as_served``): their largest
    logit gap is the reorder gap, and each packed divergence's top-2
    margins are returned; the fixed loop on the mix's first four prompts
    (its divergences from the served streams teacher-forced through it,
    margins returned); a tp = 2 fleet against the monolithic streams
    (``tp_disagg_fleet``)."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import collectives as cl
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import Request, ServeEngine

    run = RunConfig(codec=CodecConfig(cache_block=TPF_BLK))
    reqs = tpf_mix(cfg)
    v = cfg.vocab_size
    out = {}
    eng = ServeEngine(cfg, run, group=tg, n_slots=4, max_len=TPF_MAXLEN,
                      seed=0, device="cuda")
    assert eng.state.kv is None
    pk = ServeEngine(cfg, dc.replace(run, codec=dc.replace(
        run.codec, weight_backend="cuda")), group=tg, n_slots=4,
        max_len=TPF_MAXLEN, params=eng.params, compress_weights=True,
        device="cuda")
    for label, e in (("raw", eng), ("packed", pk)):
        cl.wire.reset()
        ops.reset_launch_counts()
        with RunProbe() as probe:
            results, st = e.run([Request(**r) for r in reqs])
        torch.cuda.synchronize()
        out[label] = dict(
            streams=[list(r.tokens) for r in results],
            admits=st.n_admit_dispatches, replays=st.n_replay_dispatches,
            peak_pages=st.peak_pages, pages=e._pages_in_use(),
            weight_bytes=st.weight_bytes_per_step,
            weight_raw=st.weight_raw_bytes_per_step,
            launches=ops.launch_counts(), kinds=cl.wire.snapshot()["kinds"],
            prefills=probe.prefills, step_ms=probe.steps)
    raw = out["raw"]["streams"]
    sides = [forced_as_served(cfg, e.run_cfg, e.params, reqs, raw, tg)
             for e in (eng, pk)]
    out["gap"] = max(float((a[:, :v] - b[:, :v]).abs().max())
                     for a, b in zip(*sides))
    out["ties"] = []
    for r, a, b, lr, lp in zip(reqs, raw, out["packed"]["streams"], *sides):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            out["ties"].append(("packed", r["uid"], j) + logit_margins(
                lr[j, :v], lp[j, :v])[:2])
    del pk
    # the fixed loop on the first four prompts (one length)
    prompts = torch.as_tensor(np.stack([r["prompt"] for r in reqs[:4]]),
                              device="cuda")
    n = reqs[0]["max_new_tokens"] - 1
    max_len = prompts.shape[1] + n + TPF_BLK * tg.world
    ops.reset_launch_counts()
    cl.wire.reset()
    t0 = time.perf_counter()
    toks = engine.generate(cfg, run, eng.params, prompts, n, max_len, tg)
    torch.cuda.synchronize()
    out["fixed"] = dict(tokens=toks.cpu().numpy(),
                        wall_s=time.perf_counter() - t0,
                        launches=ops.launch_counts(),
                        kinds=cl.wire.snapshot()["kinds"])
    parts = [(i, next((j for j, (x, y) in enumerate(zip(f, raw[i]))
                       if x != y), None))
             for i, f in enumerate(out["fixed"]["tokens"].tolist())]
    if any(j is not None for _, j in parts):
        ff = tp_fixed_forced(cfg, run, eng.params, prompts,
                             np.asarray(raw[:4]), max_len, tg)
        for i, j in parts:
            if j is not None:
                out["ties"].append(("fixed", i, j) + logit_margins(
                    ff[i, j, :v], sides[0][i][j, :v])[:2])
    out["disagg"] = tp_disagg_fleet(tg, cfg, run, eng, reqs, raw)
    return out


def tp_families_rank_job(tg, want):
    """One rank of the tp_families phase (spawned; ``tg`` its gloo TPGroup
    on the card): seamless and internvl2 on the fixed loop against tp =
    1's tokens ``want`` (by name), then mamba2 on every serving path."""
    import gc
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for name in TPF_STUBS:
        t0 = time.perf_counter()
        res[name] = tpf_stub(tg, tpf_cfg(name), want[name])
        res[name]["model_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["mamba2-370m"] = tpf_mamba2(tg, tpf_cfg("mamba2-370m"))
    res["mamba2-370m"]["model_s"] = time.perf_counter() - t0
    return res


def tpf_tp1(cfg):
    """A stub family at tp = 1 in this process: the fixed loop's tokens
    (``generate``: from a CUDA graph), then those tokens teacher-forced
    through its raw and its packed (``cuda``) weights: (tokens, forced
    logits raw, packed)."""
    import dataclasses as dc
    import gc
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import weights
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.serve import engine

    run = RunConfig(codec=CodecConfig(cache_block=TPF_BLK))
    b, s, n = TPF_FIXED[cfg.name]
    prompts, extras = tpf_inputs(cfg)
    max_len = s + n + TPF_BLK
    params = engine_params(cfg)
    want = engine.generate(cfg, run, params, prompts, n, max_len,
                           **extras).cpu().numpy()
    f_raw = tp_fixed_forced(cfg, run, params, prompts, want, max_len,
                            extras=extras).numpy()
    packed = weights.pack_serving_params(params, backend="cuda")
    del params
    gc.collect()
    run_pk = RunConfig(codec=dc.replace(run.codec, weight_backend="cuda"))
    f_pk = tp_fixed_forced(cfg, run_pk, packed, prompts, want, max_len,
                           extras=extras).numpy()
    del packed
    gc.collect()
    torch.cuda.empty_cache()
    return want, f_raw, f_pk


def tp_families_phase(smi):
    """The remaining families at tp = 2 on the card: two ranks
    (``launch.mesh.spawn``) on the one card over gloo, host-staged, from
    seed 0's weights (each rank's shard of the tp = 1 tree), at full width
    (depth cuts in TPF_LAYERS).  Rows 6xt and 6vt (``stub_tp_kernels``);
    seamless-m4t-large-v2 (its encoder sequence-sharded, the memory
    gathered LEXI-packed, cross attention over each rank's interleaved
    rows of the memory's K/V) and internvl2-76b (front embeds across both
    shards) on the fixed loop, held to tp = 1 as the dense family is
    (``tp_held_to_tp1``: every teacher-forced logit gap within
    TP_GAP_FACTOR x tp = 1's reorder gap, first divergences near-ties);
    mamba2-370m on ``ServeEngine`` raw and packed, the fixed loop and a
    tp = 2 fleet against a tp = 1 fleet (``link_reduction``), every
    divergence between them a near-tie within TP_GAP_FACTOR x its raw vs
    packed reorder gap, teacher-forced at the served slot count.  Both
    ranks' tokens equal everywhere.  Prints ms per prefill and decode
    step, each gather kind's wire / raw bytes and overflows, the cross
    store's stored / raw bytes.  Returns rank 0's launches and the
    rows."""
    import collections
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.launch import mesh

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = stub_tp_kernels(gen)
    torch.cuda.empty_cache()
    tp1, bounds = {}, {}
    for name in TPF_STUBS:
        cfg = tpf_cfg(name)
        tp1[name] = tpf_tp1(cfg)
        v = cfg.vocab_size
        gap1 = float(np.abs(tp1[name][1][..., :v]
                            - tp1[name][2][..., :v]).max())
        assert 0 < gap1 < float("inf"), (name, gap1)
        bounds[name] = TP_GAP_FACTOR * gap1
        log("tp_families", f"{name} at tp = 1: fixed loop "
                           f"{' x '.join(map(str, TPF_FIXED[name]))}; its "
                           f"tokens teacher-forced through its raw and its "
                           f"packed (cuda) weights: reorder gap {gap1:.6g}, "
                           f"so tp = 2 is held within {bounds[name]:.6g}")
    m_cfg = tpf_cfg("mamba2-370m")
    m_run = RunConfig(codec=CodecConfig(cache_block=TPF_BLK))
    fleet1 = disagg_fleet(m_cfg, m_run, engine_params(m_cfg),
                          tpf_mix(m_cfg))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("tp_families", f"{', '.join(TPF_LAYERS)} at tp = 2: two ranks on "
                       f"{torch.cuda.device_count()} card(s) over gloo, "
                       f"CUDA tensors staged through host memory | {smi}")
    ranks = mesh.spawn(tp_families_rank_job, 2, backend="gloo",
                       device="cuda",
                       args=({k: v[0] for k, v in tp1.items()},))
    log("tp_families", f"2 ranks done in {time.perf_counter() - t0:.1f}s "
                       f"| {smi}")
    r0, r1 = ranks
    launches = collections.Counter()
    for name in TPF_STUBS:
        cfg = tpf_cfg(name)
        a, b_ = r0[name], r1[name]
        assert np.array_equal(a["tokens"], b_["tokens"]), name
        want, f1, _ = tp1[name]
        same, n_tok, gap = tp_held_to_tp1(name, cfg, a["tokens"], want,
                                          a["forced"], f1, bounds[name])
        for k_, v_ in a["launches"].items():
            launches[k_] += v_
        assert a["launches"]["decode_attend"] > 0, a["launches"]
        for k_, v_ in a["kinds"].items():
            assert v_["overflows"] == 0 == b_["kinds"][k_]["overflows"], \
                (name, k_)
        want_kinds = {"all_gather"} | ({"encoder", "memory", "cross"}
                                       if cfg.encdec else set())
        assert set(a["kinds"]) == want_kinds, a["kinds"]
        bb, ss, nn = TPF_FIXED[name]
        ms = a["step_ms"]
        log("tp_families", f"{name} ({cfg.n_layers} layers"
                           f"{' + as many encoder layers' if cfg.encdec else ''}"
                           f", d {cfg.d_model}, {cfg.n_heads}/"
                           f"{cfg.n_kv_heads} heads of {cfg.head_dim}, "
                           f"vocab {cfg.vocab_size}) fixed loop {bb} x {ss} "
                           f"+ {nn} at tp = 2: both ranks' tokens equal; tp "
                           f"2 == tp 1 on {same}/{n_tok} tokens; "
                           f"teacher-forced logit gap tp 2 vs tp 1 max "
                           f"{gap:.6g} (bound {bounds[name]:.6g}); prefill "
                           f"{a['prefill_ms']:.1f} ms, "
                           f"{sum(ms) / len(ms):.1f} ms per decode step "
                           f"(mean of {len(ms)}, median "
                           f"{sorted(ms)[len(ms) // 2]:.1f}); rank 0 model "
                           f"{a['model_s']:.1f}s | {smi}")
        log("tp_families", f"{name} prefill's compressed gathers (rank 0): "
                           f"{tph_kind_line(a['kinds'])}")
        if cfg.encdec:
            for rank, r in enumerate(ranks):
                st_, raw_ = r[name]["xstore"]
                log("tp_families", f"{name} cross-attention store on shard "
                                   f"{rank}: {ss // 2} of {ss} memory rows "
                                   f"x {bb} sequences x {cfg.n_layers} "
                                   f"layers, {st_} B stored of {raw_} B raw "
                                   f"bf16 ({raw_ / st_:.4f}x)")
            rows["6xt"]["launches"] = a["launches"]["decode_attend"] // 2
        else:
            rows["6vt"]["launches"] = a["launches"]["decode_attend"]
    # mamba2
    a, b_ = r0["mamba2-370m"], r1["mamba2-370m"]
    reqs = tpf_mix(m_cfg)
    bound = TP_GAP_FACTOR * a["gap"]
    assert 0 < a["gap"] < float("inf"), a["gap"]
    for key in ("raw", "packed"):
        assert a[key]["streams"] == b_[key]["streams"], key
        assert a[key]["peak_pages"] == a[key]["pages"] == 0 \
            == b_[key]["pages"], key
        assert a[key]["replays"] > 0, key                  # odd tails
        for req, toks in zip(reqs, a[key]["streams"]):
            assert len(toks) == req["max_new_tokens"], key
        for k_, v_ in a[key]["launches"].items():
            launches[k_] += v_
        assert a[key]["kinds"]["all_gather"]["overflows"] == 0
    assert a["packed"]["launches"]["decompress_matmul"] > 0
    assert np.array_equal(a["fixed"]["tokens"], b_["fixed"]["tokens"])
    d0, d1 = a["disagg"], b_["disagg"]
    assert d0["streams"] == d1["streams"]
    for k_, v_ in a["fixed"]["launches"].items():
        launches[k_] += v_
    for k_, v_ in d0["launches"].items():
        launches[k_] += v_
    ties = list(a["ties"]) + [("disagg", uid, j, m, m)
                              for uid, j, _, _, m in d0["ties"]]
    for what, uid, j, m1, m2 in ties:
        tie = min(m1, m2) <= bound
        log("tp_families", f"mamba2 {what} vs the raw served stream, "
                           f"request {uid} first divergence at token {j}: "
                           f"top-2 margins {m1:.4g} / {m2:.4g} (bound "
                           f"{bound:.4g}): "
                           f"{'near-tie' if tie else 'MARGIN ABOVE THE BOUND'}")
        assert tie, (what, uid, j, m1, m2, bound)
    raw = a["raw"]["streams"]
    eq = {k: sum(x == y for s1, s2 in zip(st_, raw) for x, y in zip(s1, s2))
          for k, st_ in (("packed", a["packed"]["streams"]),
                         ("fixed", a["fixed"]["tokens"].tolist()),
                         ("disagg", d0["streams"]))}
    log("tp_families", f"mamba2-370m ({m_cfg.n_layers} layers, d "
                       f"{m_cfg.d_model}, SSM "
                       f"{m_cfg.ssm.n_heads(m_cfg.d_model)} heads, "
                       f"{m_cfg.ssm.n_heads(m_cfg.d_model) // 2} a rank, "
                       f"d_state {m_cfg.ssm.d_state}) at tp = 2: both "
                       f"ranks' streams equal on every path; no page on "
                       f"either rank; tokens equal to the raw served "
                       f"streams: packed {eq['packed']}, fixed loop "
                       f"{eq['fixed']} (of its 4 x "
                       f"{reqs[0]['max_new_tokens']}), fleet {eq['disagg']}"
                       f" of {sum(map(len, raw))}; raw vs packed reorder "
                       f"gap {a['gap']:.6g}; rank 0 model "
                       f"{a['model_s']:.1f}s")
    for key in ("raw", "packed"):
        r = a[key]
        pf = [p_["ms"] for p_ in r["prefills"]]
        ms = r["step_ms"]
        log("tp_families", f"mamba2 {key}: {len(pf)} admission prefills "
                           f"{', '.join(f'{x:.1f}' for x in pf)} ms; "
                           f"{sum(ms) / len(ms):.1f} ms per decode or "
                           f"replay step (mean of {len(ms)}, median "
                           f"{sorted(ms)[len(ms) // 2]:.1f}); weights "
                           f"{r['weight_bytes']} B / {r['weight_raw']} B "
                           f"raw per rank and step; "
                           f"{tph_kind_line(r['kinds'])} | {smi}")
    lr1, lr2 = fleet1["stats"]["link_reduction"], \
        d0["stats"]["link_reduction"]
    log("tp_families", f"mamba2 fleet at tp = 2 (each rank's SSM state in "
                       f"the blob, no page): {disagg_line(d0)}; "
                       f"link_reduction tp 2 {lr2:.4f} vs tp 1 {lr1:.4f} "
                       f"on the same prompts | {smi}")
    for tag, row in rows.items():
        log("tp_families", f"row {tag}: ms {row['ms']:.4f}, plain ms "
                           f"{row['plain_ms']:.4f}, SDPA ms "
                           f"{row['library_ms']:.4f}, bound ms "
                           f"{row['bound_ms']:.5f} ({row['bound_by']}), max "
                           f"|err| {row['max_abs_err']:.3e}, launches "
                           f"{row.get('launches')} | {smi}")
    log("tp_families", f"phase done in {time.perf_counter() - t_phase:.1f}s"
                       f" | {smi}")
    return launches


# Depth (layers of qwen3-4b's 36, width kept) of the fixed, prefix,
# disagg and tp phases, of deepseek-v2-lite-16b's 27 in the moe_mla phase
# and of zamba2-1.2b's 26 in the hybrid phase (the train phase's:
# TRAIN_LAYERS; tp_hybrid's: TPH_LAYERS; families': FAM_LAYERS): cut so
# that the whole run fits its time limit on a slower host (one run took
# 1201.7 s at full depth where another took 845.8; with the families
# phase added, 697.9 s on a host 1.19x faster than the 733.6 s one).
PREFIX_LAYERS = 12
MOE_MLA_LAYERS = 9
HYBRID_LAYERS = 8


def first_layers(cfg, params, n_layers: int):
    """``cfg`` cut to its first ``n_layers`` layers, and views of those
    layers of ``params`` (stacked block leaves)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n_layers]
    return (dataclasses.replace(cfg, n_layers=n_layers),
            dict(params, blocks=take(params["blocks"])))


def engine_params(cfg):
    """``cfg``'s seeded random weights on the card (seed 0), as
    ``ServeEngine(seed=0)`` makes them."""
    import torch
    from repro_torch.models import lm, params as PM
    gen = torch.Generator(device="cuda").manual_seed(0)
    return PM.init_params(lm.lm_table(cfg), gen, device="cuda")


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
    marks = [("start", t_start)]

    def mark(phase):
        marks.append((phase, time.perf_counter()))

    smi = device_phase()
    build_phase()
    mark("device + build")
    cfg = get_config("qwen3-4b")
    rec = kernels_phase(cfg)
    mark("kernels")
    small_phase()
    _, serve_eng, tok, served = serve_phase(cfg, smi)
    mark("small + serve")
    # launches on the main path's runs from CUDA graphs (replays counted)
    launches = graphs_phase(cfg, serve_eng, tok, served, smi)
    mark("graphs")
    launches["decode_attend"] = fixed_phase(
        *first_layers(cfg, serve_eng.params, PREFIX_LAYERS), smi)
    mark("fixed")
    raw_params = serve_eng.params
    launches.update(weights_phase(cfg, serve_eng, tok, smi))
    mark("weights")
    prefix_phase(*first_layers(cfg, raw_params, PREFIX_LAYERS), smi)
    mark("prefix")
    cfg_d = dataclasses.replace(cfg, n_layers=PREFIX_LAYERS)
    for name, n in disagg_phase(cfg_d, engine_params(cfg_d), smi).items():
        launches[name] += n
    mark("disagg")
    del raw_params, serve_eng
    for name, n in hybrid_phase(smi).items():
        launches[name] += n
    mark("hybrid")
    for name, n in moe_mla_phase(smi).items():
        launches[name] += n
    mark("moe_mla")
    for name, n in tp_phase(dataclasses.replace(
            cfg, n_layers=PREFIX_LAYERS), smi).items():
        launches[name] += n
    mark("tp")
    for name, n in tp_hybrid_phase(smi).items():
        launches[name] += n
    mark("tp_hybrid")
    for name, n in train_phase(smi).items():
        launches[name] += n
    mark("train")
    for name, n in families_phase(smi).items():
        launches[name] += n
    mark("families")
    for name, n in tp_families_phase(smi).items():
        launches[name] += n
    mark("tp_families")
    log("time", ", ".join(f"{name} {t - t0:.1f}s" for (_, t0), (name, t)
                          in zip(marks, marks[1:])) + f" | {smi}")
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
