"""The port's capturable decode steps on the CPU: the static-buffer paged
step and the device-length fixed step, against the per-step indexed form
they replace, and the decoders' split into eager (ring-flush) and
replayed steps.

A CUDA graph cannot be captured here, so ``kernels.ops.CapturedStep`` is
swapped for a stand-in that runs the warm-up where the capture would, and
the captured step again on every replay.  That runs the decoders' graph
control flow -- the warm-up that must leave the state as it found it, the
re-staging after the capture, the flush split -- on the CPU; the real
capture is held against the eager path on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import fixed
from repro_torch.core.collectives import CodecConfig
from repro_torch.kernels import decode_attend as tda
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, cache, layers, lm, params as PM
from repro_torch.serve import engine
from repro_torch.serve.scheduler import Request, ServeEngine
from torch_port_util import bf16_np, to_torch

torch.set_num_threads(2)

BLK = 4
CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=512,
                  head_dim=16, qk_norm=True)


def _run(codec_on=True):
    codec = CodecConfig(cache_block=BLK) if codec_on else \
        dataclasses.replace(CodecConfig.off(), cache_block=BLK)
    return RunConfig(codec=codec)


@pytest.fixture(scope="module")
def params():
    return PM.init_params(lm.lm_table(CFG), torch.Generator().manual_seed(5))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _pool_equal(a: cache.PagedKV, b: cache.PagedKV) -> None:
    assert (a.page_table == b.page_table).all()
    assert (a.page_used == b.page_used).all()
    assert torch.equal(_bits(a.ring), _bits(b.ring))
    for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
              "raw_pages"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(_bits(x), _bits(y)), f


class FakeCapture:
    """``ops.CapturedStep`` on the CPU: the warm-up where the capture
    would run, the step on every replay."""
    made = 0

    def __init__(self, step, warmup, device):
        warmup()
        self.step = step
        FakeCapture.made += 1

    def replay(self):
        self.step()


@pytest.fixture()
def fake_graphs(monkeypatch):
    FakeCapture.made = 0
    monkeypatch.setattr(ops, "CapturedStep", FakeCapture)
    return FakeCapture


# ---------------------------------------------------------------------------
# the masked all-slot ring write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_masked_ring_write(codec_on):
    """Every slot is written under the active mask: an inactive slot's
    ring bytes stay as they were, an active slot's row equals the old
    indexed write (ring[slot, length % blk] = K/V), and a filling ring
    compresses into its planned page exactly as ``compress_many`` of it."""
    run = _run(codec_on)
    rng = np.random.default_rng(0)
    n_slots, w = 5, cache.kv_width(CFG)
    pkv = cache.empty_paged_kv(CFG, run, n_slots, 32)
    pkv.ring.copy_(to_torch(bf16_np(rng, tuple(pkv.ring.shape), spread=4)))
    before = pkv.ring.clone()
    lengths = np.array([5, 3, 9, 7, 0], np.int32)     # slot 1 fills its ring
    active = np.array([True, True, False, False, True])
    vals = to_torch(bf16_np(rng, (n_slots, w), spread=4))
    plan = cache.plan_append(run, pkv, lengths, active)
    assert list(plan.flush_slots) == [1]
    cache.append_token_paged(CFG, run, pkv, 1, vals, plan)
    want = before[1].clone()
    for s in np.flatnonzero(active):
        want[s, lengths[s] % BLK] = vals[s]
    assert torch.equal(_bits(pkv.ring[1]), _bits(want))
    assert torch.equal(_bits(pkv.ring[0]), _bits(before[0]))   # other layer
    page = int(plan.flush_pages[0])
    assert pkv.page_table[1, 0] == page and pkv.page_used[page]
    if codec_on:
        ct = fixed.compress_many(want[1:2], k=run.codec.k,
                                 esc_capacity=run.codec.esc_capacity(
                                     want[1].numel()))
        for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw"):
            assert torch.equal(getattr(pkv, f)[1][page], getattr(ct, f)[0])
    else:
        assert torch.equal(_bits(pkv.raw_pages[1][page]), _bits(want[1]))


# ---------------------------------------------------------------------------
# the static-buffer paged step against the per-step indexed step
# ---------------------------------------------------------------------------

def _indexed_step(cfg, run, params, state, tokens):
    """The paged step in its per-step indexed form: index tensors and the
    page table built from host values every step, only the active slots'
    ring rows written, the filling rings compressed into fresh pages."""
    blk = run.codec.cache_block
    pkv = state.kv
    write = np.flatnonzero(state.active)
    ring_idx = state.lengths[write] % blk
    flush = write[ring_idx == blk - 1]
    pages = cache._alloc_pages(pkv, len(flush))
    pkv.page_table[flush, state.lengths[flush] // blk] = pages
    ids = torch.from_numpy(np.maximum(pkv.page_table, 0))
    pos = torch.tensor(state.lengths)
    post = torch.tensor(state.lengths + state.active.astype(np.int32))
    write_t, idx_t = torch.as_tensor(write), torch.as_tensor(ring_idx)
    flush_t = torch.as_tensor(flush)
    pages_t = torch.as_tensor(pages, dtype=torch.int64)
    spec = attention.base_attn_spec(cfg)
    hd = cfg.head_dim
    x = lm.embed_tokens(cfg, params["embed"], tokens)
    for i in range(cfg.n_layers):
        def attend(q, new_vals, i=i):
            ring = pkv.ring[i]
            ring[write_t, idx_t] = new_vals[write_t].to(torch.bfloat16)
            if len(flush):
                full = ring[flush_t]
                if run.codec.cache:
                    ct = fixed.compress_many(
                        full, k=run.codec.k,
                        esc_capacity=run.codec.esc_capacity(full[0].numel()))
                    for f in ("signman", "planes", "dict_syms", "esc_pos",
                              "esc_raw"):
                        getattr(pkv, f)[i][pages_t] = getattr(ct, f)
                else:
                    pkv.raw_pages[i][pages_t] = full
            out, _, l = ref.paged_decode_attend_plain(
                q[:, :, 0].contiguous(), *pkv.layer_fields(i), ring, ids,
                post, cache.WINDOW_NONE, k=run.codec.k,
                kv_idx=cache.gqa_head_table(cfg, q.shape[1]),
                scale=hd ** -0.5)
            return layers.merge_partials(out, l)[:, :, None]
        x = engine._attn_block(cfg, lm.layer_params(params, i), x, pos,
                               attend)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    state.lengths += state.active.astype(np.int32)
    return lm.logits_for(cfg, params, x)


def _admit(run, params, states, slots, prompt):
    _, d = engine.prefill_sequences(CFG, run, params, prompt)
    for st in states:
        engine.insert_sequences(CFG, run, st, d, slots)


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_static_step_matches_indexed_step(params, codec_on):
    """Over admissions, ring flushes (block 4), an idle slot, an eviction
    and a readmission into the freed pages: the static-buffer
    ``paged_decode_step`` gives the indexed step's logits, rings, pages,
    page table and page use bit for bit."""
    run = _run(codec_on)
    rng = np.random.default_rng(1)
    new = engine.empty_paged_state(CFG, run, 3, 40)
    old = engine.empty_paged_state(CFG, run, 3, 40)
    _admit(run, params, (new, old), [0, 2],
           torch.as_tensor(rng.integers(0, 512, (2, 6)), dtype=torch.int32))

    def steps(n, idle=None):
        for t in range(n):
            tok = torch.as_tensor(rng.integers(0, 512, (3, 1)),
                                  dtype=torch.int32)
            for st in (new, old):
                st.active[:] = st.lengths > 0
                if idle is not None and t % 2:
                    st.active[idle] = False
            got = engine.paged_decode_step(CFG, run, params, new, tok)
            want = _indexed_step(CFG, run, params, old, tok)
            assert torch.equal(_bits(got), _bits(want)), t
            assert (new.lengths == old.lengths).all()
            _pool_equal(new.kv, old.kv)

    steps(7, idle=2)
    mask = np.array([True, False, False])
    for st in (new, old):
        engine.release_slots(st, mask)
    _admit(run, params, (new, old), [0],
           torch.as_tensor(rng.integers(0, 512, (1, 9)), dtype=torch.int32))
    steps(6)
    assert new.kv.page_used.sum() > 0


def test_page_ids_follow_touch():
    """One device page table for the pool's life: after every host-side
    change (insert, a flush's allocation, release) it is the same tensor,
    equal to the host table with unmapped entries clipped to 0."""
    run = _run()
    rng = np.random.default_rng(2)
    pkv = cache.empty_paged_kv(CFG, run, 3, 24)
    ids = pkv.page_ids()

    def check():
        assert pkv.page_ids() is ids
        assert torch.equal(ids, torch.from_numpy(
            np.maximum(pkv.page_table, 0)))

    check()
    store = cache.fill_from_prefill(
        CFG, run, cache.empty_kv(CFG, run, 2, 24),
        to_torch(bf16_np(rng, (2, 11, cache.kv_width(CFG)))))
    cache.paged_insert_many(CFG, run, pkv, [store] * CFG.n_layers, [2, 0],
                            11)
    check()
    assert (pkv.page_table >= 0).sum() == 4
    flush, pages = cache.stage_append(run, pkv, np.array([11, 0, 11]),
                                      np.array([True, False, True]))
    assert list(flush) == [0, 2] and len(pages) == 2
    check()
    cache.release_pages(pkv, np.array([True, False, False]))
    check()
    assert (pkv.page_table[0] == -1).all()


# ---------------------------------------------------------------------------
# the decoders: which steps run eagerly, and graph steps == eager steps
# ---------------------------------------------------------------------------

def test_stage_append_flush_split():
    """The host's split: a step flushes exactly when an appending slot's
    length is one short of a block, and only those slots flush; the staged
    rows hold every slot's ring row, mask and lengths."""
    run = _run()
    pkv = cache.empty_paged_kv(CFG, run, 4, 64)
    rng = np.random.default_rng(3)
    for _ in range(50):
        lengths = rng.integers(0, 40, 4).astype(np.int32)
        active = rng.random(4) < 0.6
        pkv.page_used[:] = False
        flush, pages = cache.stage_append(run, pkv, lengths, active)
        want = [s for s in range(4)
                if active[s] and lengths[s] % BLK == BLK - 1]
        assert list(flush) == want and len(pages) == len(want)
        st = pkv.step.numpy()
        assert (st[0] == np.arange(4) * BLK + lengths % BLK).all()
        assert (st[1] == active).all() and (st[2] == lengths).all()
        assert (st[3] == lengths + active).all()


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_paged_decoder_graph_split(params, fake_graphs, codec_on):
    """``PagedDecoder`` with graphs (the stand-in capture): every step
    without a flush replays, every step with one runs eagerly, and the
    tokens, pools and lengths equal the eager decoder's bit for bit --
    decode windows, replay windows with ragged feed masks, an eviction
    and a readmission after the capture."""
    run = _run(codec_on)
    rng = np.random.default_rng(4)
    states = [engine.empty_paged_state(CFG, run, 3, 48) for _ in range(2)]
    decs = [engine.PagedDecoder(CFG, run, st, graphs=g)
            for st, g in zip(states, (False, True))]
    _admit(run, params, states, [0, 1],
           torch.as_tensor(rng.integers(0, 512, (2, 5)), dtype=torch.int32))
    tok = torch.as_tensor(rng.integers(0, 512, (3, 1)), dtype=torch.int32)
    outs = [d.decode(params, tok, 9) for d in decs]
    assert torch.equal(outs[0], outs[1])
    _pool_equal(states[0].kv, states[1].kv)
    engine.release_slots(states[0], np.array([True, False, False]))
    engine.release_slots(states[1], np.array([True, False, False]))
    _admit(run, params, states, [0, 2],
           torch.as_tensor(rng.integers(0, 512, (2, 6)), dtype=torch.int32))
    toks = torch.as_tensor(rng.integers(0, 512, (7, 3, 1)), dtype=torch.int32)
    feed = np.zeros((7, 3), bool)
    feed[:7, 0], feed[:3, 2] = True, True          # ragged tails
    outs = [d.replay(params, toks, feed) for d in decs]
    assert torch.equal(outs[0], outs[1])
    outs = [d.decode(params, d.tok.clone(), 8) for d in decs]
    assert torch.equal(outs[0], outs[1])
    _pool_equal(states[0].kv, states[1].kv)
    assert (states[0].lengths == states[1].lengths).all()
    eager, graph = decs[0].counts, decs[1].counts
    assert eager.replays == 0 and eager.eager == 24
    assert graph.captures == fake_graphs.made == 1
    assert graph.eager == graph.flush == eager.flush > 0
    assert graph.replays == 24 - graph.flush > 0


def test_serve_engine_graph_streams(params, fake_graphs):
    """``ServeEngine`` with its decoder in graph mode (the stand-in
    capture) serves the same streams as eagerly; its stats split the
    steps as the decoder ran them."""
    run = _run()
    rng = np.random.default_rng(6)
    reqs = [Request(uid=i, prompt=rng.integers(0, 512, (n,)).astype(np.int32),
                    max_new_tokens=b)
            for i, (n, b) in enumerate([(9, 7), (4, 12), (13, 5), (6, 9)])]
    got = {}
    for graphs in (False, True):
        eng = ServeEngine(CFG, run, n_slots=2, max_len=40, params=params,
                          device="cpu")
        eng.decoder.graphs = graphs
        res, st = eng.run(reqs)
        got[graphs] = [r.tokens for r in res]
        steps = st.eager_steps + st.graph_replays
        assert st.decode_steps <= steps
        if graphs:
            assert st.eager_steps == st.flush_steps > 0
            assert st.graph_replays > 0 and st.graph_captures == 1
        else:
            assert st.graph_replays == 0 and not st.cuda_graphs
    assert got[True] == got[False]


def test_cuda_graphs_need_cuda(params):
    run = _run()
    with pytest.raises(ValueError, match="cuda_graphs"):
        ServeEngine(CFG, run, n_slots=2, max_len=16, params=params,
                    device="cpu", cuda_graphs=True)
    eng = ServeEngine(CFG, run, n_slots=2, max_len=16, params=params,
                      device="cpu")
    assert not eng.cuda_graphs and not eng.decoder.graphs
    assert engine.resolve_graphs(None, "cpu") is False
    assert engine.resolve_graphs(False, "cpu") is False


# ---------------------------------------------------------------------------
# the fixed-batch loop's device length
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_append_token_device_index(codec_on):
    """The fixed store's ring write indexed by the device length equals
    the host-indexed write, through a flush."""
    run = _run(codec_on)
    rng = np.random.default_rng(7)
    w = cache.kv_width(CFG)
    kvs = [cache.empty_kv(CFG, run, 3, 24, group=3) for _ in range(2)]
    for length in range(2, 11):
        vals = to_torch(bf16_np(rng, (3, w), spread=4))
        cache.append_token(CFG, run, kvs[0], vals, length)
        cache.append_token(CFG, run, kvs[1], vals, length,
                           torch.tensor(length, dtype=torch.int32))
        for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
                  "raw_blocks", "ring"):
            a, b = getattr(kvs[0], f), getattr(kvs[1], f)
            if a is not None:
                assert torch.equal(_bits(a), _bits(b)), (length, f)


def test_fixed_decoder_graph_split(params, fake_graphs):
    """``generate`` with graphs (the stand-in capture) gives the eager
    loop's tokens and stores; the flushing steps (length % blk == blk - 1
    before the step) run eagerly, the rest replay; the device length
    follows the host's."""
    run = _run()
    rng = np.random.default_rng(8)
    prompts = torch.as_tensor(rng.integers(0, 512, (3, 6)), dtype=torch.int32)
    want = engine.generate(CFG, run, params, prompts, 11, 24)
    logits, st = engine.prefill(CFG, run, params, prompts, 24)
    dec = engine.FixedDecoder(CFG, run, params, st,
                              engine.greedy_token(logits), graphs=True)
    outs = [dec.tok.clone()]
    for _ in range(11):
        dec.step()
        outs.append(dec.tok.clone())
        assert int(st.length_dev) == st.length
    assert torch.equal(torch.cat(outs, 1), want)
    flushes = sum((6 + t) % BLK == BLK - 1 for t in range(11))
    assert dec.counts.eager == dec.counts.flush == flushes == 3
    assert dec.counts.replays == 11 - flushes and dec.counts.captures == 1
    _, st2 = engine.prefill(CFG, run, params, prompts, 24)
    tok = engine.greedy_token(logits)
    for _ in range(11):
        tok = engine.greedy_token(engine.decode_step(CFG, run, params, st2,
                                                     tok))
    for a, b in zip(st.kv, st2.kv):
        for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
                  "ring"):
            assert torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f)))


def test_fixed_decoder_capacity(params):
    """``FixedDecoder.step`` runs up to the last token the store and the
    ring hold and refuses the next step before it touches the state (the
    device-length kernel could not check that length)."""
    run = _run()
    prompts = torch.as_tensor(np.random.default_rng(9).integers(
        0, 512, (2, 6)), dtype=torch.int32)
    logits, st = engine.prefill(CFG, run, params, prompts, 8)
    nblk = st.kv[0].nblk
    assert nblk == cache.n_blocks(run, 8)
    dec = engine.FixedDecoder(CFG, run, params, st,
                              engine.greedy_token(logits), graphs=False)
    while st.length < (nblk + 1) * BLK - 1:
        dec.step()
    ring = _bits(st.kv[0].ring).clone()
    with pytest.raises(ValueError, match="does not fit"):
        dec.step()
    assert st.length == (nblk + 1) * BLK - 1 == int(st.length_dev)
    assert torch.equal(_bits(st.kv[0].ring), ring)


def test_workspace_grows_geometrically():
    """``workspace.sized`` keeps a buffer that is large enough, grows one
    that is not at least twofold (zero-filled on request) and retires the
    old one, so growing 1..1000 elements retires ~log2(1000) buffers."""
    from repro_torch.kernels import workspace
    retired = len(workspace._retired)
    a = workspace.sized(None, 5, torch.int32, "cpu", zeroed=True)
    assert a.numel() == 5 and not a.any()
    assert workspace.sized(a, 5, torch.int32, "cpu") is a
    b = workspace.sized(a, 6, torch.int32, "cpu", zeroed=True)
    assert b.numel() == 10 and not b.any()
    assert workspace._retired[-1] is a
    assert workspace.sized(b, 25, torch.float32, "cpu").numel() == 25
    buf = None
    for n in range(1, 1001):
        buf = workspace.sized(buf, n, torch.float32, "cpu")
    assert buf.numel() == 1024
    assert len(workspace._retired) - retired == 2 + 10
    del workspace._retired[retired:]


@pytest.mark.parametrize("window", [None, 1, 5, 12], ids=["full", "w1",
                                                         "w5", "w12"])
def test_fixed_attend_device_length(window):
    """``decode_attend_plain`` with the length as a 0-d int32 tensor (the
    kernel's device-length form) equals the host-int form bit for bit at
    lengths across span and block edges, and the device-length launch's
    grid -- every span of the store's capacity, the dead ones merged in
    -- equals the host-length grid's spans within 1e-6."""
    h, hkv, hd = 8, 4, 16
    blk, b, nblk = 8, 3, 4
    w = 2 * hkv * hd
    win = ref.WINDOW_NONE if window is None else window
    kw = dict(kv_idx=tuple(min(i // (h // hkv), hkv - 1) for i in range(h)),
              scale=hd ** -0.5)
    span = tda.span_rows(blk)
    cap = tda.capacity_splits(nblk, blk)
    assert cap == (nblk + 1) * blk // span
    for length in (0, 1, 3, 4, 5, 7, 8, 9, 16, 17, 31, 32, 33, 39):
        rng = np.random.default_rng(length)
        blocks = to_torch(bf16_np(rng, (nblk, b, blk, w), 0.5))
        ring = to_torch(bf16_np(rng, (b, blk, w), 0.5))
        q = to_torch(bf16_np(rng, (b, h, hd)))
        host = ref.decode_attend_plain(q, *(None,) * 5, blocks, ring, length,
                                       win, k=5, **kw)
        dev = ref.decode_attend_plain(
            q, *(None,) * 5, blocks, ring,
            torch.tensor(length, dtype=torch.int32), win, k=5, **kw)
        for x, y in zip(host, dev):
            assert torch.equal(x, y), length
        vals, ok = ref.fixed_stream(blocks[:length // blk], ring, length, win)
        first, n = tda.fixed_splits(length, win, blk)
        (o1, m1, l1), _ = ref.split_partials_plain(q, vals, ok, span,
                                                   first=first, nsplit=n,
                                                   **kw)
        (o2, m2, l2), (_, ms, _) = ref.split_partials_plain(
            q, vals, ok, span, first=0, nsplit=cap, **kw)
        live = (ms != ref.NEG_INF).any(-1).any(-1).nonzero().flatten()
        if len(live):
            assert first <= int(live.min()) and int(live.max()) < first + n
        torch.testing.assert_close(o2, o1, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(l2, l1, rtol=1e-6, atol=1e-6)
        assert torch.equal(m2, m1)
