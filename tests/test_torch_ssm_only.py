"""The attention-free Mamba2 model on the port's serving paths
(device="cpu", weights bridged from the reference) against the reference
at tp = 1, on the reference tests' attention-free case
(``tests/test_decode.py``'s "ssm": 2 layers, d 64, d_state 16, headdim 8,
chunk 16; block 4):

- ``ServeEngine``, codec on and off: the reference's greedy streams and
  admission counts, and no pages at all (``peak_pages`` 0, as the
  reference's; the model has no KV, so the codec flag reaches no cache);
- the fixed loop (``engine.generate``) against the reference's
  prefill + ``decode_step``;
- the packed weight plane: the port's packed leaves byte for byte the
  reference's, and packed streams equal to the raw ones;
- a disaggregated fleet: streams equal to the monolithic engine's; the
  blob carries no KV section (no ``_FLAG_KV``) and serializes to the
  reference serializer's bytes; each handoff's wire bytes equal the
  reference prefill replica's; a reference prefill replica feeds a port
  decode replica with the monolithic streams;
- the launcher in its three modes at reduced mamba2-370m.

Streams are compared for identity: near-ties widen nothing."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ModelConfig as JModel, RunConfig as JRun
from repro.configs.base import MeshConfig, SSMConfig as JSSM
from repro.core import collectives as jcl, weights as jweights
from repro.core.collectives import CodecConfig as JCodec
from repro.models import lm as jlm, params as jparams
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve import disagg as jdisagg, engine as jengine
from repro.serve import transport as jtransport
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.core import weights as tweights
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.models import cache as tcache
from repro_torch.models.params import from_jax_params
from repro_torch.serve import engine as tengine
from repro_torch.serve.disagg import DisaggEngine
from repro_torch.serve.scheduler import Request, ServeEngine
from torch_port_util import bf16_np, bits

torch.set_num_threads(2)

KW = dict(name="s", family="ssm", n_layers=2, d_model=64, n_heads=0,
          n_kv_heads=0, d_ff=0, vocab_size=500, sub_quadratic=True)
SSM_KW = dict(d_state=16, headdim=8, chunk=16)
JCFG, TCFG = JModel(ssm=JSSM(**SSM_KW), **KW), TModel(ssm=TSSM(**SSM_KW),
                                                      **KW)
MAXLEN, SLOTS, BLK = 48, 2, 4


def _trun(codec_on: bool) -> TRun:
    return TRun(codec=TCodec(cache_block=BLK) if codec_on else
                dataclasses.replace(TCodec.off(), cache_block=BLK))


def _mix(cls=Request):
    """Three prompt lengths (each its own exact trunk), more requests than
    slots, budgets that cross ring-block boundaries."""
    rng = np.random.default_rng(0)
    specs = [(8, 5), (13, 6), (5, 9), (13, 4)]
    return [cls(uid=i, prompt=rng.integers(0, 500, (s,)).astype(np.int32),
                max_new_tokens=n) for i, (s, n) in enumerate(specs)]


def _stream(results):
    return [(r.tokens, r.stop_reason) for r in results]


@pytest.fixture(scope="module")
def ref():
    """The reference engine (codec on; sharing is off by itself: no
    pages) and its streams on the mix; its seeded weights with the
    zeros/ones SSM leaves made to count, bridged."""
    jrun = JRun(codec=JCodec(cache_block=BLK))
    je = JEngine(JCFG, jrun, tp=1, n_slots=SLOTS, max_len=MAXLEN, seed=1,
                 max_fuse_steps=1)
    params = jax.device_get(je.params)
    rng = np.random.default_rng(5)
    s = params["blocks"]["ssm"]
    s["dt_bias"] = bf16_np(rng, s["dt_bias"].shape, 0.5)
    s["a_log"] = bf16_np(rng, s["a_log"].shape, 0.5)
    for name in ("d_skip", "gate_norm"):
        s[name] = (1 + bf16_np(rng, s[name].shape, 0.2).astype(
            np.float32)).astype(ml_dtypes.bfloat16)
    je.params = jax.tree_util.tree_map(jnp.asarray, params)
    res, st = je.run(_mix(JRequest))
    return dict(jrun=jrun, je=je, jparams=params,
                params=from_jax_params(params), mono=_stream(res), stats=st)


def _engine(ref, codec_on=True, **kw):
    return ServeEngine(TCFG, _trun(codec_on), n_slots=SLOTS, max_len=MAXLEN,
                       params=ref["params"], max_fuse_steps=1, device="cpu",
                       **kw)


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_streams_identical_and_no_pages(ref, codec_on):
    te = _engine(ref, codec_on)
    assert te.state.kv is None and not te.prefix_sharing
    assert te._n_pages == te._maxp == 0
    res, st = te.run(_mix())
    assert _stream(res) == ref["mono"]
    js = ref["stats"]
    assert st.peak_pages == js.peak_pages == 0
    assert st.peak_cache_bytes == js.peak_cache_bytes == 0
    assert st.n_admit_dispatches == js.n_admit_dispatches
    assert st.n_replay_dispatches == js.n_replay_dispatches == 0
    assert st.decode_steps == js.decode_steps
    assert te._pages_in_use() == 0 and not te.state.active.any()
    # the pool's bytes are the SSM state of every slot, nothing else
    ssm_bytes = sum(t.numel() * t.element_size() for t in te.state.ssm)
    assert ssm_bytes == 2 * SLOTS * (16 * 8 * 16 * 4 + 3 * (128 + 32) * 2)
    assert te.sync_metrics(te._new_loop()).value("serve.pool_bytes") \
        == tengine.paged_state_nbytes(te.state) == ssm_bytes
    assert tcache.page_bytes(TCFG, _trun(codec_on)) == (0, 0)


def test_fixed_loop_matches_reference(ref):
    """The fixed loop: 3 prompts of 10 tokens, 8 greedy steps, against
    the reference's prefill + decode_step.  Fed the reference's tokens,
    the port's logits are within 5e-3 at every step and layer 0's
    recurrent state within 1e-4; the port's own greedy stream
    (``generate``) equals the reference's up to the first step whose
    reference top-2 margin is within 1e-2 (``ROADMAP.md`` section 3,
    item 2)."""
    atol = 5e-3
    jrun, trun = ref["jrun"], _trun(True)
    jp = jax.tree_util.tree_map(jnp.asarray, ref["jparams"])
    dims = ref["je"].dims
    mesh = jax.make_mesh((1, 1), ("data", "model"))

    def shm_jit(f, n):
        return jax.jit(jcl.shmap(f, mesh, tuple(P() for _ in range(n)), P()))

    s, n, max_len = 10, 8, 24
    prefill = shm_jit(lambda p, t: jengine.prefill(JCFG, jrun, p, dims, t,
                                                   max_len, 1), 2)
    step = shm_jit(lambda p, st, tok: jengine.decode_step(
        JCFG, jrun, p, dims, st, tok, 1), 3)
    prompts = np.random.default_rng(3).integers(0, 500, (3, s)) \
        .astype(np.int32)
    lg, st = prefill(jp, jnp.asarray(prompts))
    assert st.kv is None and st.xkv is None
    lt, tst = tengine.prefill(TCFG, trun, ref["params"],
                              torch.as_tensor(prompts), max_len)
    assert tst.kv is None and tst.xkv is None
    want, got_lg, want_lg = [], [], []
    for t in range(n + 1):
        want_lg.append(np.asarray(lg)[:, 0, :500])
        got_lg.append(lt.numpy()[:, 0, :500])
        want.append(want_lg[-1].argmax(-1).astype(np.int32))
        if t == n:
            break
        tok = want[-1][:, None]
        lg, st = step(jp, st, jnp.asarray(tok))
        lt = tengine.decode_step(TCFG, trun, ref["params"], tst,
                                 torch.as_tensor(tok))
    want, want_lg = np.stack(want, 1), np.stack(want_lg, 1)
    np.testing.assert_allclose(np.stack(got_lg, 1), want_lg, atol=atol)
    np.testing.assert_allclose(tst.ssm.h[0].numpy(), np.asarray(st.ssm.h)[0],
                               rtol=1e-4, atol=1e-4)
    got = tengine.generate(TCFG, trun, ref["params"],
                           torch.as_tensor(prompts), n, max_len).numpy()
    top2 = np.sort(want_lg, -1)[..., -2:]
    near_tie = top2[..., 1] - top2[..., 0] <= 2 * atol       # (B, n + 1)
    for b in range(3):
        diff = np.flatnonzero(got[b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0], got[b], want[b])


def test_packed_leaves_and_streams(ref):
    """``pack_serving_params``: the port's packed leaves equal the
    reference's byte for byte (k too), the same leaves stay raw; the
    packed engine serves the raw streams."""
    table = jlm.lm_table(JCFG, MeshConfig(data=1, model=1, pod=1),
                         ref["jrun"])
    jpk, _ = jweights.pack_serving_params(
        ref["jparams"], jparams.param_pspecs(table), tp=1)
    tpk = tweights.pack_serving_params(from_jax_params(ref["jparams"]))
    js, ts = jpk["blocks"]["ssm"], tpk["blocks"]["ssm"]
    assert set(js) == set(ts)
    packed = []
    for name in sorted(ts):
        if not isinstance(ts[name], tweights.PackedWeight):
            assert not hasattr(js[name], "signman"), name
            continue
        packed.append(name)
        assert ts[name].k == js[name].k, name
        assert (bits(ts[name].signman) == bits(js[name].signman)).all()
        assert (bits(ts[name].planes) == bits(
            np.asarray(js[name].planes).view(np.int32))).all(), name
        assert (bits(ts[name].dict_syms) == bits(js[name].dict_syms)).all()
    assert packed == ["w_out", "w_zx"]
    te = _engine(ref, compress_weights=True)
    res, st = te.run(_mix())
    assert _stream(res) == ref["mono"]
    assert st.weights_compressed and st.weight_ratio < 1.0


def _to_ref_blob(blob):
    """The port's blob as the reference's ``SequenceBlob`` (bf16 leaves as
    ml_dtypes bf16, the same bits)."""
    f = dataclasses.asdict(blob)
    h, cx, cbc = blob.ssm
    f["ssm"] = (h, cx.view(ml_dtypes.bfloat16), cbc.view(ml_dtypes.bfloat16))
    return jtransport.SequenceBlob(**f)


def test_disagg_fleet_and_wire(ref):
    """A prefill replica hands off to a decode replica: the monolithic
    streams; every blob is the SSM state alone (no KV section, no
    columns, no ``_FLAG_KV``), arrives byte for byte and serializes to the
    reference serializer's bytes; a reference prefill replica feeding the
    port's decode replica gives the same streams and the same wire bytes,
    handoff by handoff."""
    def fleet():
        return DisaggEngine(TCFG, _trun(True), n_slots=SLOTS,
                            max_len=MAXLEN, params=ref["params"],
                            max_fuse_steps=1, device="cpu", streaming=True)

    dis = fleet()
    assert not dis.prefills[0].streaming           # no pages to stream
    blobs, imported = [], []
    export, imp = dis.prefills[0]._export_blob, dis.decodes[0].import_handoff

    def watch_export(s):
        blobs.append(export(s))
        return blobs[-1]

    def watch_import(h):
        s = imp(h)
        imported.append([t[:, s].clone() for t in dis.decodes[0].engine
                         .state.ssm])
        return s

    dis.prefills[0]._export_blob = watch_export
    dis.decodes[0].import_handoff = watch_import
    res, st = dis.run(_mix())
    assert _stream(res) == ref["mono"]
    assert len(blobs) == st.n_transfers > 0
    ours = {}
    for blob, got in zip(blobs, imported):
        assert blob.kv is None and blob.n_cols == 0 and blob.w == 0
        data = blob.to_wire(None)[0]
        flags = jtransport._HDR.unpack_from(data)[2]
        assert not flags & jtransport._FLAG_KV and flags & \
            jtransport._FLAG_SSM
        assert _to_ref_blob(blob).to_wire(None)[0] == data
        assert (got[0].numpy() == blob.ssm[0][0]).all()
        ours[blob.length, tuple(blob.emitted)] = len(data)
    assert st.wire_bytes == sum(ours.values())

    # the reference's prefill replica (its engine) through the port's
    # transport into a port decode replica
    dis = fleet()
    pick = dis.prefills[0].pick_dst
    jpre = jdisagg.PrefillReplica(ref["je"], transport=dis.transport,
                                  pick_dst=pick)
    theirs = {}
    jexport = jpre._export_blob

    def watch_ref(s):
        blob = jexport(s)
        theirs[blob.length, tuple(blob.emitted)] = len(blob.to_wire(None)[0])
        return blob

    jpre._export_blob = watch_ref
    dis.prefills = [jpre]
    res, jst = dis.run(_mix(JRequest))
    assert _stream(res) == ref["mono"]
    assert theirs == ours and jst.wire_bytes == st.wire_bytes
    assert jst.wire_raw_bytes == st.wire_raw_bytes


@pytest.mark.parametrize("mode", [[], ["--continuous"], ["--disagg"]],
                         ids=["fixed", "continuous", "disagg"])
def test_launcher_serves_mamba2(mode, capsys):
    """``launch.serve --arch mamba2-370m`` (its reduced variant) in each
    mode."""
    from repro_torch.launch import serve

    size = (["--batch", "2", "--prompt-len", "12", "--new-tokens", "3"]
            if not mode else ["--requests", "3", "--slots", "2",
                              "--prompt-len", "16", "--new-tokens", "3"])
    assert serve.main(["--arch", "mamba2-370m", "--device", "cpu"] + mode
                      + size) == 0
    out = capsys.readouterr().out
    assert "sample continuations" in out
    if mode == ["--continuous"]:
        assert "paged cache peak 0 pages" in out
