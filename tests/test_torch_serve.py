"""The port's ``ServeEngine`` (device="cpu", weights bridged from the
reference) against the reference ``ServeEngine(tp=1,
prefix_sharing=False)``: identical greedy token streams and stop reasons
on tiny dense models — GQA 8:4 (the serving bench's model) with the codec
on and off, MHA with qkv biases, GQA with qk-norm — with more requests
than slots, mixed prompt lengths (cold trunks, tail replays, ring flushes,
page reuse) and EOS / stop-sequence / budget termination.  Plus a
teacher-forced run: the reference's tokens fed to both engines' decode
steps, logits compared at every step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig, ModelConfig as JModel
from repro.configs.base import RunConfig as JRun
from repro.core import collectives as jcl
from repro.core.collectives import CodecConfig as JCodec
from repro.launch.disagg_host import tiny_bench_config
from repro.models import lm as jlm
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve import engine as jengine
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.models.params import from_jax_params
from repro_torch.serve import engine as tengine
from repro_torch.serve.scheduler import Request as TRequest
from repro_torch.serve.scheduler import ServeEngine as TEngine
from torch_port_util import bf16_np

torch.set_num_threads(2)

MAXLEN, SLOTS, BLK = 48, 2, 4


def _cfg_kw(name):
    base = dataclasses.asdict(tiny_bench_config())
    if name == "mha-bias":
        base.update(name="mha", n_heads=4, n_kv_heads=4, qkv_bias=True)
    elif name == "qknorm":
        base.update(name="qkn", qk_norm=True, rope_theta=1e6)
    return base


CASES = {"gqa-codec": ("gqa", True), "gqa-raw": ("gqa", False),
         "mha-bias": ("mha-bias", True), "qknorm": ("qknorm", True)}


def _runs(codec_on):
    jc = JCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=BLK)
    tc = TCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=BLK)
    return JRun(codec=jc), TRun(codec=tc)


def _mix(vocab, seed=0):
    """(prompt, budget) pairs: trunk-only, trunk + tail replay, a tail
    that crosses a page, more requests than slots."""
    rng = np.random.default_rng(seed)
    specs = [(8, 5), (13, 6), (4, 9), (23, 4), (11, 7)]
    return [(rng.integers(0, vocab, (s,)).astype(np.int32), b)
            for s, b in specs]


def _stream(results):
    return [(r.tokens, r.stop_reason) for r in results]


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request):
    """Reference engine + its streams on the mix, and the bridged weights.
    For the GQA codec case a second run (same compiled engine) adds
    per-request EOS and stop-sequence overrides taken from run one."""
    name, codec_on = CASES[request.param]
    kw = _cfg_kw(name)
    jcfg, tcfg = JModel(**kw), TModel(**kw)
    jrun, trun = _runs(codec_on)
    # one decode step per dispatch: the reference's streams do not depend
    # on its fused window length (its own tests hold them equal), and one
    # step compiles once instead of once per window length
    je = JEngine(jcfg, jrun, tp=1, n_slots=SLOTS, max_len=MAXLEN, seed=1,
                 prefix_sharing=False, max_fuse_steps=1)
    params = jax.device_get(je.params)
    if jcfg.qkv_bias:                 # zero-init biases would not count
        rng = np.random.default_rng(9)
        attn = params["blocks"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn[b] = bf16_np(rng, attn[b].shape, 0.05)
        je.params = jax.tree_util.tree_map(jnp.asarray, params)
    mix = _mix(jcfg.vocab_size)
    jres, _ = je.run([JRequest(uid=i, prompt=p, max_new_tokens=b)
                      for i, (p, b) in enumerate(mix)])
    runs = [(mix, {}, _stream(jres))]
    if request.param == "gqa-codec":
        s0, s1 = jres[0].tokens, jres[1].tokens
        over = {0: dict(eos_id=int(s0[2])),
                1: dict(stop_seqs=[[int(t) for t in s1[1:3]]]),
                3: dict(eos_id=int(jres[3].tokens[-1]) + 1)}
        jres2, _ = je.run([JRequest(uid=10 + i, prompt=p, max_new_tokens=b,
                                    **over.get(i, {}))
                           for i, (p, b) in enumerate(mix)])
        runs.append((mix, over, _stream(jres2)))
    return dict(jcfg=jcfg, jrun=jrun, tcfg=tcfg, trun=trun,
                params=from_jax_params(params), jparams=params, runs=runs)


def test_streams_identical(served):
    for mix, over, want in served["runs"]:
        te = TEngine(served["tcfg"], served["trun"], n_slots=SLOTS,
                     max_len=MAXLEN, params=served["params"], device="cpu",
                     prefix_sharing=False)
        res, st = te.run([TRequest(uid=i, prompt=p, max_new_tokens=b,
                                   **over.get(i, {}))
                          for i, (p, b) in enumerate(mix)])
        assert _stream(res) == want
        assert st.n_requests == len(mix) and st.decode_steps > 0
        assert st.decode_backend == "torch" and st.peak_pages > 0
        if served["trun"].codec.cache:
            assert st.peak_cache_bytes < st.peak_cache_raw_bytes
        else:
            assert st.peak_cache_bytes == st.peak_cache_raw_bytes
        assert not te.state.active.any()
        assert not te.state.kv.page_used.any()      # every page released
    if len(served["runs"]) > 1:                     # overrides did fire
        reasons = [r for _, r in served["runs"][1][2]]
        assert {"eos", "stop_string", "budget"} <= set(reasons)


def test_teacher_forced_logits(served):
    """Feed the reference's greedy tokens to both engines' paged decode
    step for 12 steps (several ring flushes at block 4): logits within
    atol 5e-3 at every step, and the same argmax wherever the reference's
    top-2 margin exceeds twice that."""
    atol = 5e-3
    jcfg, jrun = served["jcfg"], served["jrun"]
    tcfg, trun = served["tcfg"], served["trun"]
    jp = jax.tree_util.tree_map(jnp.asarray, served["jparams"])
    dims = jlm.lm_fsdp_dims(jlm.lm_table(
        jcfg, MeshConfig(data=1, model=1, pod=1), jrun))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    prompts = np.stack([p[:8] for p, _ in _mix(jcfg.vocab_size)[:2]])

    def admit(pp, toks):
        st = jengine.empty_paged_state(jcfg, jrun, 2, MAXLEN, 1)
        lg, d = jax.vmap(lambda t: jengine.prefill(
            jcfg, jrun, pp, dims, t[None], MAXLEN, 1))(toks)
        st = jengine.insert_sequences(jcfg, jrun, st, d, jnp.arange(2), 8, 1)
        return lg[:, 0], st

    def step(pp, st, tok):
        return jengine.paged_decode_step(jcfg, jrun, pp, dims, st, tok, 1)

    jadmit = jax.jit(jcl.shmap(admit, mesh, (P(), P()), P()))
    jstep = jax.jit(jcl.shmap(step, mesh, (P(), P(), P()), P()))
    lj, jst = jadmit(jp, jnp.asarray(prompts))
    tst = tengine.empty_paged_state(tcfg, trun, 2, MAXLEN, device="cpu")
    lt, d = tengine.prefill_sequences(tcfg, trun, served["params"],
                                      torch.as_tensor(prompts))
    tengine.insert_sequences(tcfg, trun, tst, d, [0, 1])
    v = jcfg.vocab_size
    for t in range(13):
        a, b = np.asarray(lj)[..., :v], lt.numpy()[..., :v]
        np.testing.assert_allclose(b, a, atol=atol, err_msg=f"step {t}")
        top2 = np.sort(a, -1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) > 2 * atol
        assert (a.argmax(-1)[sure] == b.argmax(-1)[sure]).all(), t
        tok = a.argmax(-1).astype(np.int32).reshape(2, 1)
        lj, jst = jstep(jp, jst, jnp.asarray(tok))
        lt = tengine.paged_decode_step(tcfg, trun, served["params"], tst,
                                       torch.as_tensor(tok))
    assert (tst.lengths == 8 + 13).all()
    assert (np.asarray(jst.kv.page_table)[0] == tst.kv.page_table).all()


def test_engine_validation():
    tcfg = TModel(**_cfg_kw("gqa"))
    _, trun = _runs(True)
    assert TEngine(tcfg, trun, device="cpu", prefix_sharing=True) \
        .prefix_sharing
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: nothing to refuse")
        TEngine(tcfg, trun)                          # default device: cuda
    te = TEngine(tcfg, trun, n_slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        te.run([TRequest(uid=0, prompt=np.arange(12, dtype=np.int32),
                         max_new_tokens=8)])         # exceeds max_len
    with pytest.raises(ValueError):
        te.run([TRequest(uid=1, prompt=np.arange(3, dtype=np.int32),
                         max_new_tokens=2, stop_seqs=[[]])])
