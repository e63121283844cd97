"""The port's fixed-batch serving path against the JAX package at tp = 1
(a 1x1 mesh): the batch-shared block store, ``decode_attend``'s plain
version and the ``prefill`` + ``decode_step`` loop.

- ``ref.decode_attend_plain`` against the reference's oracle
  (``ref.decode_attend_ref``) and its ``jax`` decode backend
  (``cache.attend_cache``), within rtol = atol = 1e-4 on the normalised
  attention: GQA / MQA / MHA, codec on and off, full, windowed and
  soft-capped, with a block whose escapes overflow the batch-shared side
  channel inside sequence 2 (after sequence 0's escapes took the first
  slots).  The reference's ``interpret`` backend is never used (it cannot
  run on jax 0.9).
- The store's bytes (every compressed field or the raw blocks, and the
  rings) equal the reference's after the prefill fill and after every
  append, through two ring flushes.  Neither package clears a ring after a
  flush, so the whole rings are compared, stale rows included.
- The ``prefill`` + ``decode_step`` loop against the reference launcher's
  (``prefill``, then ``decode_step`` compiled once with its traced length
  and stepped on the host) on the tiny dense models of
  test_torch_serve.py, through two ring flushes: teacher-forced logits
  within 5e-3, and ``engine.generate``'s greedy streams equal to the
  reference's up to the first near-tie of the reference's own logits.
- Reduced gemma2-9b (window 16 on alternating layers, attention softcap
  50, final softcap 30, post-norms, sqrt(d) embedding scaling):
  teacher-forced logits within 2% of the logit scale, with the greedy
  agreement printed.

The CUDA kernel is held against the plain version in test_torch_gpu.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config, make_reduced as jreduce
from repro.configs.base import MeshConfig, ModelConfig as JModel
from repro.configs.base import RunConfig as JRun
from repro.core import collectives as jcl
from repro.core import fixed as jfixed
from repro.core.collectives import CodecConfig as JCodec
from repro.kernels import ref as jref
from repro.launch.disagg_host import tiny_bench_config
from repro.models import cache as jcache, layers as jlayers, lm as jlm
from repro.models import params as jparams
from repro.serve import engine as jengine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import make_reduced as treduce
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import fixed as tfixed
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import cache as tcache, layers as tlayers
from repro_torch.models.params import from_jax_params
from repro_torch.serve import engine as tengine
from torch_port_util import bf16_np, bits, to_np, to_torch

torch.set_num_threads(2)

MESH = jax.make_mesh((1, 1), ("data", "model"))
HEADS = {"gqa": (4, 2), "mqa": (5, 1), "mha": (8, 8)}
HD, BLK, B, NBLK, K = 16, 8, 3, 4, 5
LENGTH = 2 * BLK + 5          # two full blocks, 5 ring rows; blocks 2-3 dead
CASES = {"full": (None, None), "windowed": (9, None), "softcap": (None, 30.0)}


def shm_jit(f, n_args):
    """``f`` jitted under shard_map on the 1x1 mesh."""
    return jax.jit(jcl.shmap(f, MESH, tuple(P() for _ in range(n_args)),
                             P()))


def _codecs(codec_on, blk):
    if codec_on:
        return JCodec(cache_block=blk), TCodec(cache_block=blk)
    return (dataclasses.replace(JCodec.off(), cache_block=blk),
            dataclasses.replace(TCodec.off(), cache_block=blk))


def _store_cfgs(heads, codec_on, blk=BLK):
    h, hkv = heads
    kw = dict(name="f", family="dense", n_layers=1, d_model=64, n_heads=h,
              n_kv_heads=hkv, d_ff=64, vocab_size=64, head_dim=HD)
    jc, tc = _codecs(codec_on, blk)
    return JModel(**kw), JRun(codec=jc), TModel(**kw), TRun(codec=tc)


def _blocks(heads, seed=0):
    """(nblk, B, blk, W) bf16 blocks: block 1 holds four rare exponents in
    sequence 0 (escapes in the first slots) and values spread over ~60
    exponents in sequence 2 (escapes past the capacity)."""
    w = 2 * heads[1] * HD
    rng = np.random.default_rng(seed)
    blocks = bf16_np(rng, (NBLK, B, BLK, w), 0.5)
    row = blocks[1, 0].astype(np.float32).reshape(-1)
    row[[3, 40, 77, 100]] = [2.0 ** -60, -2.0 ** -59, 2.0 ** -58,
                             -2.0 ** -57]
    blocks[1, 0] = row.reshape(BLK, w).astype(blocks.dtype)
    blocks[1, 2] = bf16_np(rng, (BLK, w), 0.5, spread=30)
    ring = bf16_np(rng, (B, BLK, w), 0.5)
    q = bf16_np(rng, (B, heads[0], HD))
    return blocks, ring, q


def _kv_idx(heads):
    h, hkv = heads
    g = max(h // hkv, 1)
    return tuple(min(i // g, hkv - 1) for i in range(h))


def _check_overflow_in_sequence_2(ct, w):
    """Block 1's side channel: sequence 0's escapes (the four planted
    ones among them) take the first slots, sequence 2's follow and
    overflow the capacity."""
    n_seq = BLK * w
    pos = ct.esc_pos[1]
    assert int(ct.n_escapes[1]) > pos.shape[0]
    assert int((pos < n_seq).sum()) >= 4 and bool((pos >= 2 * n_seq).any())


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference_oracle(heads, codec_on, case):
    hh = HEADS[heads]
    window, softcap = CASES[case]
    blocks, ring, q = _blocks(hh)
    w = blocks.shape[-1]
    win = tref.WINDOW_NONE if window is None else window
    kv_idx, scale = _kv_idx(hh), HD ** -0.5
    if codec_on:
        n = B * BLK * w
        ct = tfixed.compress_many(to_torch(blocks.reshape(NBLK, n)), k=K,
                                  esc_capacity=max(n // 128, 8))
        _check_overflow_in_sequence_2(ct, w)
        fields = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos,
                  ct.esc_raw, None)
        # the oracle sees what the codec stores (overflow decodes lossy)
        seen = np.asarray(jax.vmap(lambda v: jfixed.decompress(
            jfixed.compress(v, k=K)))(jnp.asarray(blocks)))
    else:
        fields, seen = (None,) * 5 + (to_torch(blocks),), blocks
    args = (to_torch(q), *fields, to_torch(ring), LENGTH, win)
    kw = dict(k=K, kv_idx=kv_idx, scale=scale, softcap=softcap)
    out, m, l = tref.decode_attend_plain(*args, **kw)
    got = (out / l.clamp(min=1e-30)[..., None]).numpy()
    want = np.asarray(jref.decode_attend_ref(
        jnp.asarray(q), jnp.asarray(seen), jnp.asarray(ring), LENGTH,
        kv_idx=kv_idx, scale=scale, softcap=softcap, window=win, tp=1, ti=0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the oracle of the port on the same decompressed blocks agrees too
    got_ref = tref.decode_attend_ref(to_torch(q), to_torch(seen),
                                     to_torch(ring), LENGTH, kv_idx=kv_idx,
                                     scale=scale, softcap=softcap,
                                     window=win).numpy()
    np.testing.assert_allclose(got_ref, want, rtol=1e-4, atol=1e-4)
    # the ops wrapper takes the plain version for CPU tensors
    o2, m2, l2 = ops.decode_attend(*args, **kw)
    assert torch.equal(o2, out) and torch.equal(l2, l) and torch.equal(m2, m)


def _stores(jcfg, jrun, tcfg, trun, blocks, ring, length):
    """The same blocks and ring in both packages' fixed-batch stores."""
    max_len = (NBLK - 2) * BLK                 # n_blocks = NBLK
    jkv = jcache.empty_kv(jcfg, jrun, B, max_len, 1)
    tkv = tcache.empty_kv(tcfg, trun, B, max_len, group=B)
    for i in range(NBLK):
        jkv = jcache.store_block(jkv, i, jnp.asarray(blocks[i]), jrun.codec)
        tcache.store_block(tkv, i, to_torch(blocks[i]), trun.codec)
    jkv = jkv._replace(ring=jnp.asarray(ring),
                       length=jnp.asarray(length, jnp.int32))
    tkv.ring.copy_(to_torch(ring))
    return jkv, tkv


def _assert_stores_equal(jkv, tkv):
    assert (bits(np.asarray(jkv.ring)) == bits(tkv.ring)).all(), "ring"
    for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
              "raw_blocks"):
        a, b = getattr(jkv, f), getattr(tkv, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.shape[0] == 1, f                  # one group of B
            assert (bits(np.asarray(a)) == bits(b[0])).all(), f


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("window", [None, 9], ids=["full", "windowed"])
def test_attend_cache_matches_jax_backend(heads, codec_on, window):
    """``cache.attend_cache`` of both packages on byte-identical stores: the
    f32 normalised attention within 1e-4 (the reference's jax-backend scan
    body), and the public bf16 results within one bf16 rounding."""
    hh = HEADS[heads]
    jcfg, jrun, tcfg, trun = _store_cfgs(hh, codec_on)
    blocks, ring, q = _blocks(hh, seed=1)
    w = blocks.shape[-1]
    jkv, tkv = _stores(jcfg, jrun, tcfg, trun, blocks, ring, LENGTH)
    _assert_stores_equal(jkv, tkv)
    spec_kw = dict(windowed=window is not None)
    jspec, tspec = jlayers.AttnSpec(**spec_kw), tlayers.AttnSpec(**spec_kw)
    q4 = jnp.asarray(q)[:, :, None]
    win = jcache.effective_window(jspec, window)

    # the reference's jax-backend body, before its bf16 merge
    load = lambda i: jcache.load_block(jkv, i, B, BLK, w, jrun.codec)
    valid = lambda i: jnp.broadcast_to(jcache.stream_mask(
        LENGTH, i, BLK, 1, 0, win, ring=False)[None], (B, BLK))
    ring_ok = jnp.broadcast_to(jcache.stream_mask(
        LENGTH, 0, BLK, 1, 0, win, ring=True)[None], (B, BLK))
    o, _, l = jcache._attend_scan_jax(jcfg, q4, jspec, hh[0], load, NBLK,
                                      valid, jkv.ring, ring_ok)
    want = np.asarray(o / jnp.maximum(l, 1e-30)[..., None])[:, :, 0]
    fields = tuple(None if f is None else f[0] for f in
                   (tkv.signman, tkv.planes, tkv.dict_syms, tkv.esc_pos,
                    tkv.esc_raw, tkv.raw_blocks))
    out, _, lt = tref.decode_attend_plain(
        to_torch(q), *fields, tkv.ring, LENGTH,
        tcache.effective_window(tspec, window), k=K,
        kv_idx=tcache.gqa_head_table(tcfg, hh[0]), scale=HD ** -0.5)
    got = (out / lt.clamp(min=1e-30)[..., None]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    jout = shm_jit(lambda qq: jcache.attend_cache(
        jcfg, jrun, jkv, qq, jspec, 1, window=window), 1)(q4)
    tout = tcache.attend_cache(tcfg, trun, tkv, to_torch(q4), LENGTH, tspec,
                               window=window)
    a = np.asarray(jout).astype(np.float32)
    b = to_np(tout).astype(np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=2.0 ** -8, atol=1e-4)
    # a block decodes to what was stored (lossy only past the capacity)
    for i in (0, 2, 3):
        assert (bits(tcache.load_block(tkv, i, trun.codec))
                == bits(blocks[i])).all(), i


def test_attend_cache_needs_the_batch_shared_store():
    jcfg, jrun, tcfg, trun = _store_cfgs(HEADS["gqa"], True)
    tkv = tcache.empty_kv(tcfg, trun, B, 16)              # group 1
    q = torch.zeros((B, 4, 1, HD), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="batch-shared"):
        tcache.attend_cache(tcfg, trun, tkv, q, 0, tlayers.AttnSpec())
    cuda_run = TRun(codec=dataclasses.replace(trun.codec,
                                              decode_backend="cuda"))
    tkv = tcache.empty_kv(tcfg, trun, B, 16, group=B)
    with pytest.raises(ValueError, match="CUDA"):
        tcache.attend_cache(tcfg, cuda_run, tkv, q, 0, tlayers.AttnSpec())


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_empty_state_matches_reference(codec_on):
    """The zeroed fixed-batch state: every layer's store equal byte for
    byte (escape slots hold the empty sentinel), length 0."""
    jcfg, jrun, tcfg, trun = _store_cfgs(HEADS["gqa"], codec_on)
    jcfg = dataclasses.replace(jcfg, n_layers=2)
    tcfg = dataclasses.replace(tcfg, n_layers=2)
    jst = jengine.empty_state(jcfg, jrun, B, 30, 1)
    tst = tengine.empty_state(tcfg, trun, B, 30)
    assert int(jst.length) == tst.length == 0 and len(tst.kv) == 2
    for i, tkv in enumerate(tst.kv):
        assert tkv.group == B
        _assert_stores_equal(jax.tree_util.tree_map(lambda a: a[i], jst.kv),
                             tkv)


@pytest.mark.parametrize("window", [None, 6], ids=["causal", "windowed"])
def test_flash_attention_ragged_chunks(window):
    """A prompt length that is not a multiple of the attention chunk (the
    fixed batch prefills any length; the reference asserts whole chunks):
    20 positions in chunks of 8 against the reference's chunks of 4,
    within one bf16 rounding."""
    rng = np.random.default_rng(3)
    q, k, v = (bf16_np(rng, (2, h, 20, HD)) for h in (4, 2, 2))
    pos = np.arange(20, dtype=np.int32)
    kw = dict(windowed=window is not None)
    want = jlayers.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pos),
        jnp.asarray(pos), jlayers.AttnSpec(**kw), window=window, chunk_q=4,
        chunk_kv=4)
    tpos = torch.as_tensor(pos)
    got = tlayers.flash_attention(
        *(to_torch(a) for a in (q, k, v)), tpos, tpos,
        tlayers.AttnSpec(**kw), window=window, chunk_q=8, chunk_kv=8)
    np.testing.assert_allclose(to_np(got).astype(np.float32),
                               np.asarray(want).astype(np.float32),
                               rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_store_bytes_identical(codec_on):
    """Prefill fill, then appends through two ring flushes (block 4, 9
    prompt tokens, 9 appends): every field and ring equal after each."""
    blk, s, steps = 4, 9, 9
    jcfg, jrun, tcfg, trun = _store_cfgs(HEADS["gqa"], codec_on, blk=blk)
    w = jcache.kv_width(jcfg)
    max_len = s + steps + blk
    rng = np.random.default_rng(6)
    vals = bf16_np(rng, (B, s, w), spread=12)
    jkv = shm_jit(lambda v: jcache.fill_from_prefill(
        jcfg, jrun, jcache.empty_kv(jcfg, jrun, B, max_len, 1), v, s, 1),
        1)(jnp.asarray(vals))
    tkv = tcache.fill_from_prefill(
        tcfg, trun, tcache.empty_kv(tcfg, trun, B, max_len, group=B),
        to_torch(vals))
    _assert_stores_equal(jkv, tkv)
    if codec_on:
        assert int(jfixed.compress(jnp.asarray(vals[:, :blk]), k=K)
                   .n_escapes) > 0                  # the escape path runs
    jstep = shm_jit(lambda kv, v: jcache.append_token(jcfg, jrun, kv, v, 1),
                    2)                               # compiled once
    flushes = 0
    for t in range(steps):
        new = bf16_np(rng, (B, w), spread=12)
        jkv = jstep(jkv, jnp.asarray(new))
        tcache.append_token(tcfg, trun, tkv, to_torch(new), s + t)
        flushes += (s + t) % blk == blk - 1
        _assert_stores_equal(jkv, tkv)
        assert int(jkv.length) == s + t + 1
    assert flushes == 2


# ---------------------------------------------------------------------------
# the serving loop: prefill + decode_step against the reference's
# ---------------------------------------------------------------------------

def _tiny_kw(name):
    base = dataclasses.asdict(tiny_bench_config())
    if name == "mha-bias":
        base.update(name="mha", n_heads=4, n_kv_heads=4, qkv_bias=True)
    elif name == "qknorm":
        base.update(name="qkn", qk_norm=True, rope_theta=1e6)
    return base


def _ref_params(jcfg, jrun, seed):
    """The reference's seeded init; zero-init qkv biases made to count."""
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=1, pod=1), jrun)
    params = jax.device_get(jparams.init_params(table, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    attn = params["blocks"]["attn"]
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = bf16_np(rng, attn[b].shape, 0.05)
    return params, jlm.lm_fsdp_dims(table)


class RefLoop:
    """The reference launcher's fixed-batch loop at tp = 1: ``prefill``
    compiled per prompt shape, ``decode_step`` compiled once (the state's
    length is traced) and stepped from the host."""

    def __init__(self, jcfg, jrun, params, dims, max_len):
        self.params = jax.tree_util.tree_map(jnp.asarray, params)
        self.prefill = shm_jit(lambda p, t: jengine.prefill(
            jcfg, jrun, p, dims, t, max_len, 1), 2)

        self.step = shm_jit(lambda p, st, tok: jengine.decode_step(
            jcfg, jrun, p, dims, st, tok, 1), 3)
        self.greedy = shm_jit(lambda lg: jengine.greedy_token(jcfg, lg, 1),
                              1)

    def logits(self, prompts, feed):
        """Last-position logits after the prompt, then after each of the
        ``feed`` (N, B) tokens: (N + 1, B, V) numpy, and the final state."""
        lg, st = self.prefill(self.params, jnp.asarray(prompts))
        out = [np.asarray(lg)[:, 0]]
        for tok in feed:
            lg, st = self.step(self.params, st, jnp.asarray(tok)[:, None])
            out.append(np.asarray(lg)[:, 0])
        return np.stack(out), st

    def stream(self, prompts, n):
        lg, st = self.prefill(self.params, jnp.asarray(prompts))
        tok = self.greedy(lg)
        toks = [np.asarray(tok)]
        for _ in range(n):
            lg, st = self.step(self.params, st, tok)
            tok = self.greedy(lg)
            toks.append(np.asarray(tok))
        return np.concatenate(toks, 1), st


STREAM_CASES = {"gqa-codec": ("gqa", True), "gqa-raw": ("gqa", False),
                "mha-bias": ("mha-bias", True), "qknorm": ("qknorm", True)}
ATOL = 5e-3       # f32 logits across frameworks (test_torch_serve.py)


def _margins(logits):
    top2 = np.sort(logits, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streams_match_reference(case):
    """3 prompts of 10 tokens, 8 greedy steps at block 4 (flushes at 12
    and 16).  Fed the reference's tokens, the port's logits are within
    ATOL of the reference's at every step.  The port's own greedy stream
    equals the reference's up to the first step where the reference's
    top-2 margin is within 2 * ATOL (a near-tie that f32 sums taken in
    another order may break either way); streams that meet no such step
    are identical.  The codec is lossless: codec on and off give the same
    stream."""
    name, codec_on = STREAM_CASES[case]
    kw = _tiny_kw(name)
    jc, tc = _codecs(codec_on, 4)
    jcfg, jrun, tcfg, trun = JModel(**kw), JRun(codec=jc), TModel(**kw), \
        TRun(codec=tc)
    s, n = 10, 8
    max_len = s + n + 4
    params, dims = _ref_params(jcfg, jrun, seed=1)
    tp = from_jax_params(params)
    ref = RefLoop(jcfg, jrun, params, dims, max_len)
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (3, s)).astype(np.int32)
    want, jst = ref.stream(prompts, n)
    assert int(jst.length) == s + n
    v = jcfg.vocab_size
    want_lg = ref.logits(prompts, want[:, :n].T)[0][..., :v]
    lg, st = tengine.prefill(tcfg, trun, tp, torch.as_tensor(prompts),
                             max_len)
    forced = [lg[:, 0].numpy()]
    for t in range(n):
        forced.append(tengine.decode_step(
            tcfg, trun, tp, st, torch.as_tensor(want[:, t:t + 1]))
            [:, 0].numpy())
    assert st.length == s + n
    np.testing.assert_allclose(np.stack(forced)[..., :v], want_lg,
                               atol=ATOL)

    got = tengine.generate(tcfg, trun, tp, torch.as_tensor(prompts), n,
                           max_len)
    assert got.dtype == torch.int32 and got.shape == (3, n + 1)
    got = got.numpy()
    near_tie = _margins(want_lg).T <= 2 * ATOL            # (B, n + 1)
    for b in range(3):
        diff = np.flatnonzero(got[b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0], got[b], want[b])
    first = [int(np.flatnonzero(g != w)[0]) if (g != w).any() else None
             for g, w in zip(got, want)]
    print(f"{case}: first divergence per sequence {first} of {n + 1} "
          f"tokens (None: identical)")
    if codec_on:
        _, off = _codecs(False, 4)
        got_off = tengine.generate(tcfg, TRun(codec=off), tp,
                                   torch.as_tensor(prompts), n, max_len)
        assert (got_off.numpy() == got).all()


def test_gemma2_teacher_forced_logits():
    """Reduced gemma2-9b, 2 prompts of 40 tokens, block 8, 12 steps fed the
    reference's greedy tokens: logits within 2% of the reference's logit
    scale (max |logit|) at every step, and the same argmax wherever the
    reference's top-2 margin exceeds twice that bound."""
    jcfg = jreduce(jget_config("gemma2-9b"))
    tcfg = treduce(tget_config("gemma2-9b"))
    assert repr(jcfg) == repr(tcfg)
    assert jcfg.window == 16 and jcfg.attn_softcap and jcfg.post_norm
    jc, tc = _codecs(True, 8)
    jrun, trun = JRun(codec=jc), TRun(codec=tc)
    s, n = 40, 12
    max_len = s + n + 8
    params, dims = _ref_params(jcfg, jrun, seed=2)
    ref = RefLoop(jcfg, jrun, params, dims, max_len)
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, s)).astype(np.int32)
    want_tok, _ = ref.stream(prompts, n)
    want, _ = ref.logits(prompts, want_tok[:, :n].T)
    tp = from_jax_params(params)
    lg, st = tengine.prefill(tcfg, trun, tp, torch.as_tensor(prompts),
                             max_len)
    got = [lg[:, 0].numpy()]
    for t in range(n):
        got.append(tengine.decode_step(
            tcfg, trun, tp, st, torch.as_tensor(want_tok[:, t:t + 1]))
            [:, 0].numpy())
    got = np.stack(got)
    v = jcfg.vocab_size
    a, b = want[..., :v], got[..., :v]
    scale = float(np.abs(a).max())
    bound = 0.02 * scale
    err = float(np.abs(a - b).max())
    top2 = np.sort(a, -1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * bound
    agree = float((a.argmax(-1) == b.argmax(-1)).mean())
    print(f"gemma2-9b reduced: max |logit diff| {err:.3e} at logit scale "
          f"{scale:.3f} (bound {bound:.3e}); greedy agreement {agree:.3f} "
          f"over {a.shape[0] * a.shape[1]} positions")
    assert err <= bound, (err, bound)
    assert (a.argmax(-1)[sure] == b.argmax(-1)[sure]).all()
