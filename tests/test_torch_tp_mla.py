"""MLA (multi-head latent attention, deepseek-v2) at tp > 1: the port
against the reference on the same numpy-seeded inputs.

* The MLA latent path of both attention kernels' plain twins on the
  tensor-parallel shard path (``kernels.ref.paged_decode_attend_plain`` /
  ``decode_attend_plain`` with ``mla_lora``, ``tp`` and ``ti``) against
  the reference's oracles (``repro.kernels.ref``) at tp 2 and 4, every
  shard, codec on and off, full, windowed and soft-capped, within 1e-4:
  one 64-wide latent row per position (lora 48 + rope 16; k the row, v
  its first 48 columns), shard ``ti`` holding the interleaved positions
  p % tp == ti.
* A tiny MLA + MoE model at tp = 2 (2 layers, d 64, 4 heads, lora 48 +
  rope 16, nope 16, v 32; 8 experts top-2 of d_ff 64 and one shared
  expert; block 4): the port on two spawned gloo ranks
  (``launch.mesh.spawn`` running ``launch.tp_jobs``, which imports no
  JAX) against the reference on two of conftest's fake devices, with the
  reference's weights cut to each rank's shard:

  - ``ServeEngine(tp=2)`` codec on and off on a mix with odd prompt
    lengths (their one-token tails replay): both ranks alike, the
    admission and replay dispatches the reference's, the streams the
    reference's ``ServeEngine(tp=2)``'s except at a near-tie of its own
    logits (``torch_tp_ref.part_at_near_ties``, ``ROADMAP.md`` section 3,
    item 2), the paged path teacher-forced within 5e-3;
  - the fixed loop: teacher-forced logits within 5e-3, streams equal up
    to the first reference top-2 margin within 1e-2;
  - packed weights: each rank's packed MLA leaves (``wq``, ``w_dkv``
    row-sharded, ``w_uv``, ``wo``) and expert stacks are the reference's
    ``pack_serving_params(..., tp=2)`` shards byte for byte, and the
    packed streams equal the raw;
  - ``DisaggEngine(tp=2)``, streaming on: the monolithic engine's
    streams, each blob carrying both ranks' latent pages.

The MoE at tp = 2 is the reference's tp = 2 function (section 3, item
6: its shared experts' prefill), so tp = 2 is held against the
reference's tp = 2, never against tp = 1."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MeshConfig, MLAConfig as JMLA
from repro.configs.base import ModelConfig as JModel, MoEConfig as JMoE
from repro.configs.base import RunConfig as JRun
from repro.core import weights as jweights
from repro.core.collectives import CodecConfig as JCodec
from repro.kernels import ref as jref
from repro.models import lm as jlm, params as JPM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs.base import MLAConfig as TMLA
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import fixed
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.kernels import ref as tref
from repro_torch.launch import mesh, tp_jobs
from repro_torch.models import lm as tlm, params as tparams
from torch_port_util import bf16_np, to_np, to_torch
from torch_tp_ref import (first_replay, part_at_near_ties, ref_fixed,
                          ref_forced, tree_np)

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# the kernels' plain twins, MLA x tp
# ---------------------------------------------------------------------------

LORA, ROPE, H, KB, KBLK = 48, 16, 4, 5, 4
W = LORA + ROPE
SCALE = (16 + ROPE) ** -0.5
CASES = {"full": (None, None), "windowed": (5, None), "softcap": (None, 30.0)}


def _stores(rng, n_rec, lead, codec_on):
    """Random (n_rec, *lead, KBLK, W) latent records, record 0's
    exponents spread past the dictionary (escapes that overflow the side
    channel), as the kernel's fields (port-compressed) and as the oracle
    sees them (decoded; overflow decodes lossy)."""
    vals = bf16_np(rng, (n_rec,) + lead + (KBLK, W), 0.5)
    vals[0] = bf16_np(rng, lead + (KBLK, W), 0.5, spread=30)
    if not codec_on:
        return (None,) * 5 + (to_torch(vals),), vals
    ct = fixed.compress_many(to_torch(vals).reshape(n_rec, -1), k=KB)
    seen = to_np(fixed.decompress(ct)).reshape(vals.shape)
    return (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
            None), seen


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tp", [2, 4])
def test_paged_mla_plain_matches_oracle_every_shard(tp, case, codec_on):
    window, softcap = CASES[case]
    win = tref.WINDOW_NONE if window is None else window
    rng = np.random.default_rng(tp * 10 + len(case))
    lengths = np.asarray([3 * KBLK * tp + 2, KBLK * tp + 1, 0, tp - 1,
                          2 * KBLK * tp], np.int32)
    n_s, maxp = len(lengths), 4
    q = bf16_np(rng, (n_s, H, W))
    pool, seen = _stores(rng, n_s * maxp, (), codec_on)
    table = rng.permutation(n_s * maxp).reshape(n_s, maxp).astype(np.int32)
    ring = bf16_np(rng, (n_s, KBLK, W), 0.5)
    kw = dict(kv_idx=(), scale=SCALE, softcap=softcap, mla_lora=LORA)
    for ti in range(tp):
        loc = [tref.local_length(int(L), tp, ti) for L in lengths]
        assert max(loc) // KBLK < maxp
        out, m, l = tref.paged_decode_attend_plain(
            to_torch(q), *pool, to_torch(ring), torch.as_tensor(table),
            torch.as_tensor(lengths), win, k=KB, tp=tp, ti=ti, **kw)
        assert tuple(out.shape) == (n_s, H, LORA)
        got = (out / l.clamp(min=1e-30)[..., None]).numpy()
        want = np.asarray(jref.paged_decode_attend_ref(
            jnp.asarray(q), jnp.asarray(seen), jnp.asarray(table),
            jnp.asarray(lengths), jnp.asarray(ring), window=win, tp=tp,
            ti=ti, **kw))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        dead = np.asarray(loc) == 0
        assert (l.numpy()[dead] == 0).all()
        assert (m.numpy()[dead] == tref.NEG_INF).all()


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tp", [2, 4])
def test_fixed_mla_plain_matches_oracle_every_shard(tp, case, codec_on):
    window, softcap = CASES[case]
    win = tref.WINDOW_NONE if window is None else window
    rng = np.random.default_rng(tp * 20 + len(case))
    b, nblk = 2, 4
    q = bf16_np(rng, (b, H, W))
    store, seen = _stores(rng, nblk, (b,), codec_on)
    ring = bf16_np(rng, (b, KBLK, W), 0.5)
    kw = dict(kv_idx=(), scale=SCALE, softcap=softcap, mla_lora=LORA)
    for length in (0, tp - 1, KBLK * tp + 1, 2 * KBLK * tp + 3,
                   3 * KBLK * tp + 2):
        for ti in range(tp):
            out, m, l = tref.decode_attend_plain(
                to_torch(q), *store, to_torch(ring), length, win, k=KB,
                tp=tp, ti=ti, **kw)
            got = (out / l.clamp(min=1e-30)[..., None]).numpy()
            want = np.asarray(jref.decode_attend_ref(
                jnp.asarray(q), jnp.asarray(seen), jnp.asarray(ring), length,
                window=win, tp=tp, ti=ti, **kw))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            if tref.local_length(length, tp, ti) == 0:
                assert (l.numpy() == 0).all()


# ---------------------------------------------------------------------------
# a tiny MLA + MoE model at tp = 2
# ---------------------------------------------------------------------------

TP, MAXLEN, SLOTS, BLK = 2, 48, 2, 4
MODEL = dict(name="dv", family="moe", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=4, d_ff=0, vocab_size=500, head_dim=16)
MLA_KW = dict(kv_lora_rank=48, qk_nope_dim=16, qk_rope_dim=16, v_dim=32)
MOE_KW = dict(n_experts=8, top_k=2, d_ff=64, n_shared=1)


def cfgs():
    return (JModel(mla=JMLA(**MLA_KW), moe=JMoE(**MOE_KW), **MODEL),
            TModel(mla=TMLA(**MLA_KW), moe=TMoE(**MOE_KW), **MODEL))


def _runs(codec_on):
    jc = JCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=BLK)
    tc = TCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=BLK)
    return JRun(codec=jc), TRun(codec=tc)


def _mix():
    """Odd lengths (13, 9: a one-token tail replays at tp = 2), a repeat,
    more requests than slots."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 500, (8,)).astype(np.int32)
    specs = [(a, 5), (rng.integers(0, 500, (13,)), 4),
             (rng.integers(0, 500, (9,)), 6), (a, 3)]
    return [dict(uid=i, prompt=np.asarray(p, np.int32).copy(),
                 max_new_tokens=n) for i, (p, n) in enumerate(specs)]


SERVE = dict(n_slots=SLOTS, max_len=MAXLEN, max_fuse_steps=1)


@pytest.fixture(scope="module")
def served():
    """Every port job on one spawn of two ranks, in a thread while the
    reference serves, runs its fixed loop and packs."""
    jcfg, tcfg = cfgs()
    jrun, trun = _runs(True)
    gen = torch.Generator().manual_seed(5)
    params = tree_np(tparams.init_params(tlm.lm_table(tcfg, TP), gen))
    s, n = 10, 8
    max_len = s + n + BLK * TP
    prompts = np.random.default_rng(3).integers(0, 500, (3, s)) \
        .astype(np.int32)
    ref = dict(params=params, fixed=ref_fixed(jcfg, jrun, TP, params,
                                              prompts, n, max_len))
    calls = [("serve", (tcfg, _runs(c)[1], _mix(), dict(
        params=params, forced=True, engine=SERVE))) for c in (True, False)]
    calls.append(("serve", (tcfg, trun, _mix(), dict(
        params=params, packed_leaves=True,
        engine=dict(SERVE, compress_weights=True)))))
    calls.append(("fixed", (tcfg, trun, prompts, n, max_len, dict(
        params=params, forced=ref["fixed"][0][:, :n]))))
    calls.append(("disagg", (tcfg, trun, _mix(), dict(
        params=params, blobs=True,
        engine=dict(SERVE, n_prefill=1, n_decode=1, streaming=True)))))
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(mesh.spawn, tp_jobs.batch, TP, backend="gloo",
                          args=(calls,))
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        for codec_on in (True, False):
            je = JEngine(jcfg, _runs(codec_on)[0], tp=TP, params=jparams,
                         **SERVE)
            res, st = je.run([JRequest(**r) for r in _mix()])
            streams = [(list(r.tokens), r.stop_reason) for r in res]
            k = first_replay(_mix(), TP)
            ref[codec_on] = dict(
                streams=streams,
                stats=(st.n_admit_dispatches, st.n_replay_dispatches),
                replay=ref_forced(jcfg, jrun, TP, params,
                                  _mix()[k]["prompt"], streams[k][0], BLK)
                if codec_on else None)
        table = jlm.lm_table(jcfg, MeshConfig(data=1, model=TP, pod=1), jrun)
        packed, specs = jweights.pack_serving_params(
            jparams, JPM.param_pspecs(table), tp=TP)
        ref["packed"] = dict(params=jax.tree_util.tree_map(np.asarray,
                                                           packed),
                             specs=specs)
        ranks = job.result()
    return ref, ranks


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_streams_equal_the_reference(served, codec_on):
    ref, ranks = served
    i = 0 if codec_on else 1
    want = ref[codec_on]
    got = ranks[0][i]["runs"][0]["streams"]
    for r in range(TP):
        run = ranks[r][i]["runs"][0]
        assert run["streams"] == got, r
        assert (run["stats"]["n_admit_dispatches"],
                run["stats"]["n_replay_dispatches"]) == want["stats"]
    assert want["stats"][1] > 0                  # odd tails replayed
    jcfg, _ = cfgs()
    forced = ranks[0][i]["runs"][0]["forced"]
    assert part_at_near_ties(jcfg, _runs(True)[0], TP, ref["params"],
                             _mix(), got, want["streams"], forced,
                             want["replay"] if codec_on else None,
                             BLK) <= 1


def test_fixed_loop_matches_reference(served):
    """Teacher-forced logits within 5e-3; the greedy streams equal the
    reference's up to its first top-2 margin within 1e-2."""
    ref, ranks = served
    want, logits = ref["fixed"]
    v = MODEL["vocab_size"]
    got0 = ranks[0][3]
    assert (ranks[1][3]["tokens"] == got0["tokens"]).all()
    np.testing.assert_allclose(got0["logits"][..., :v], logits[..., :v],
                               atol=5e-3)
    top2 = np.sort(logits[..., :v], -1)[..., -2:]
    near_tie = ((top2[..., 1] - top2[..., 0]) <= 1e-2).T     # (B, n + 1)
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got0["tokens"][b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0])


def test_packed_leaves_are_the_reference_shards(served):
    """Each rank's PackedWeight leaves are the reference's packed whole
    leaves cut along their PartitionSpec's model dim, byte for byte (the
    row-sharded ``w_dkv`` and ``wo`` on their input dim); the packed
    streams equal the raw ones."""
    ref, ranks = served
    raw = ranks[0][0]["runs"][0]["streams"]
    for r in range(TP):
        assert ranks[r][2]["runs"][0]["streams"] == raw
    params, specs = ref["packed"]["params"], ref["packed"]["specs"]
    paths = set(ranks[0][2]["packed"])
    assert {"blocks/attn/wq", "blocks/attn/w_dkv", "blocks/attn/w_uv",
            "blocks/attn/wo", "blocks/moe/w_gate"} <= paths
    for path in paths:
        node, spec = params, specs
        for key in path.split("/"):
            node, spec = node[key], spec[key]
        for f in ("signman", "planes", "dict_syms"):
            whole = np.asarray(getattr(node, f))
            sp = tuple(getattr(spec, f))
            sp = sp + (None,) * (whole.ndim - len(sp))
            for r in range(TP):
                part = whole
                if "model" in sp:
                    part = np.split(whole, TP, axis=sp.index("model"))[r]
                got = ranks[r][2]["packed"][path]
                assert int(node.k) == got["k"], path
                assert (got[f].view(np.uint8) == part.view(np.uint8)).all(), \
                    (path, f, r)


def test_rank_heads_and_latent_rows():
    """Each rank's MLA shard: its query heads' columns of ``wq``,
    ``w_uk`` and ``w_uv``, its rows of ``w_dkv`` and ``wo``; a padded
    head count pads every per-head projection with zero heads."""
    _, tcfg = cfgs()
    t = tlm.lm_table(tcfg, TP)["blocks"]["attn"]
    loc = {k: tparams.local_shape(d, TP) for k, d in t.items()}
    assert loc["wq"] == (2, 64, 2 * 32) and loc["w_uk"] == (2, 48, 2 * 16)
    assert loc["w_uv"] == (2, 48, 2 * 32) and loc["wo"] == (2, 2 * 32, 64)
    assert loc["w_dkv"] == (2, 32, 64) and loc["kv_norm"] == (2, 48)
    three = dataclasses.replace(tcfg, n_heads=3, n_kv_heads=3)
    p1 = tparams.init_params(tlm.lm_table(three), torch.Generator()
                             .manual_seed(0))
    p2 = tparams.pad_for_tp(p1, three, TP)["blocks"]["attn"]
    want = tlm.lm_table(three, TP)["blocks"]["attn"]
    for k, d in want.items():
        assert tuple(p2[k].shape) == d.shape, k
    assert not p2["wq"][..., 3 * 32:].any() and not p2["wo"][:, 3 * 32:].any()
    assert not p2["w_uk"][..., 3 * 16:].any()


def test_disagg_fleet_serves_the_monolithic_streams(served):
    """Latent pages cross the link per rank: the fleet's streams are the
    monolithic tp = 2 engine's, both ranks alike, every transferred
    blob's pages both ranks' 64-wide latent rows."""
    from repro_torch.serve.transport import SequenceBlob

    _, ranks = served
    mono = ranks[0][0]["runs"][0]["streams"]
    for r in range(TP):
        assert ranks[r][4]["streams"] == mono, r
    st = ranks[0][4]["stats"]
    assert st["n_transfers"] == len(_mix()) and st["pages_streamed"] > 0
    for b in ranks[0][4]["blobs"]:
        blob = SequenceBlob.from_wire(b["wire"])
        assert (blob.tp, blob.w) == (TP, W) and blob.to_wire()[0] == \
            b["wire"]
