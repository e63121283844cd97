"""The port's Mamba2 mixer and parallel hybrid block against the JAX
package at tp = 1, on the same numpy-seeded inputs and bridged weights:
``ssd_chunked`` (a tail padded to the chunk, a prompt shorter than one
chunk), ``ssm_forward`` with its final state, ``ssm_decode_step``, the
hybrid block, the trunk and the prefill's last-position logits, the
parameter tables, and the packed serving store of the SSM leaves.

Tolerances: f32 states rtol = atol = 1e-4 (the scan's sums run in another
order); bf16 results within 1e-2; f32 logits within 5e-3 (as the dense
family's tests)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig, ModelConfig as JModel
from repro.configs.base import RunConfig as JRun, SSMConfig as JSSM
from repro.configs import get_config as jget_config
from repro.core import collectives as jcl
from repro.core import weights as jweights
from repro.core.collectives import CodecConfig as JCodec
from repro.models import blocks as jblocks, lm as jlm, params as jparams
from repro.models import attention as jattn, ssm as jssm
from repro.serve import engine as jengine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun, SSMConfig as TSSM
from repro_torch.core import weights as tweights
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.models import attention as tattn, blocks as tblocks
from repro_torch.models import lm as tlm, params as tparams, ssm as tssm
from repro_torch.serve import engine as tengine
from torch_port_util import bf16_np, bits, to_np, to_torch

torch.set_num_threads(2)

MESH = jax.make_mesh((1, 1), ("data", "model"))
HYB = dict(name="h", family="hybrid", n_layers=3, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=500, head_dim=16,
           parallel_hybrid=True, attn_layout="hymba_3global", window=16,
           sub_quadratic=True)
SSM_KW = dict(d_state=16, headdim=8, chunk=16)


def cfgs(**over):
    kw = dict(HYB, **over)
    return (JModel(ssm=JSSM(**SSM_KW), **kw),
            TModel(ssm=TSSM(**SSM_KW), **kw))


def shm(f, *args):
    return jax.jit(jcl.shmap(f, MESH, tuple(P() for _ in args), P()))(*args)


def ref_params(jcfg, jrun, seed):
    """The reference's seeded init, with the zeros/ones SSM leaves
    (dt_bias, a_log, d_skip, gate_norm) made to count."""
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=1, pod=1), jrun)
    params = jax.device_get(jparams.init_params(table, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    s = params["blocks"]["ssm"]
    s["dt_bias"] = bf16_np(rng, s["dt_bias"].shape, 0.5)
    s["a_log"] = bf16_np(rng, s["a_log"].shape, 0.5)
    s["d_skip"] = (1 + bf16_np(rng, s["d_skip"].shape, 0.2)
                   .astype(np.float32)).astype(s["d_skip"].dtype)
    s["gate_norm"] = (1 + bf16_np(rng, s["gate_norm"].shape, 0.2)
                      .astype(np.float32)).astype(s["gate_norm"].dtype)
    return params, jlm.lm_fsdp_dims(table)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(to_np(got), np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = cfgs()
    jrun, trun = JRun(codec=JCodec(cache_block=4)), \
        TRun(codec=TCodec(cache_block=4))
    params, dims = ref_params(jcfg, jrun, 1)
    return jcfg, jrun, tcfg, trun, params, tparams.from_jax_params(params), \
        dims


def test_softplus_matches_jax():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [0.0, 19.99, 20.0, 20.01, 88.0]]).astype(np.float32)
    np.testing.assert_allclose(
        tssm.softplus(torch.as_tensor(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("s", [40, 16, 9])
def test_ssd_chunked(s):
    """A 40-token sequence at chunk 16 (a tail padded by 8), one whole
    chunk, and a sequence shorter than the chunk."""
    rng = np.random.default_rng(s)
    b, h, p_, n = 2, 4, 8, 16
    x = bf16_np(rng, (b, s, h, p_))
    dt = np.log1p(np.exp(rng.normal(0, 1, (b, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(0, 0.5, (h,))).astype(np.float32)
    bb, cc = bf16_np(rng, (b, s, n), 0.5), bf16_np(rng, (b, s, n), 0.5)
    yj, hj = jax.jit(lambda *t: jssm.ssd_chunked(*t, 16))(
        *(jnp.asarray(t) for t in (x, dt, a, bb, cc)))
    yt, ht = tssm.ssd_chunked(*(to_torch(t) for t in (x, dt, a, bb, cc)), 16)
    assert ht.shape == (b, h, p_, n) and ht.dtype == torch.float32
    close(ht, hj, 1e-4, 1e-4)
    assert yt.dtype == torch.bfloat16 and yt.shape == (b, s, h, p_)
    close(yt, yj, 1e-2, 1e-2)


def test_tables_and_bridge(model):
    jcfg, jrun, tcfg, _, params, tp_, _ = model
    jt = jlm.lm_table(jcfg, MeshConfig(data=1, model=1, pod=1), jrun)
    tt = tlm.lm_table(tcfg)
    jleaves = {jax.tree_util.keystr(k): (v.shape, v.init) for k, v in
               jax.tree_util.tree_flatten_with_path(
                   jt, is_leaf=jparams.is_pdef)[0]}

    def flat(t, path=""):
        if isinstance(t, tparams.PDef):
            return {path: (t.shape, t.init)}
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{path}['{k}']"))
        return out

    assert flat(tt) == jleaves
    assert set(tt["blocks"]["ssm"]) == set(jssm.ssm_table(jcfg, 1))
    gen = torch.Generator().manual_seed(0)
    init = tparams.init_params(tt, gen)
    s = init["blocks"]["ssm"]
    assert (s["dt_bias"] == 0).all() and (s["d_skip"] == 1).all()
    assert 0.05 < float(s["conv_x"].float().std()) < 0.2
    for k, v in params["blocks"]["ssm"].items():
        assert (bits(tp_["blocks"]["ssm"][k]) == bits(v)).all(), k
    # the full-width hybrids' layer tables (jamba's FFN is MoE), and the
    # attention-free family's: the Mamba2 mixer alone, the reference's
    # leaves and shapes
    assert "ssm" in tblocks.block_table(tget_config("zamba2-1.2b"))
    jamba = tblocks.block_table(tget_config("jamba-tiny-dev"))
    assert {"ssm", "moe"} <= set(jamba) and "mlp" not in jamba
    mamba = tblocks.block_table(tget_config("mamba2-370m"))
    jmamba = jblocks.block_table(jget_config("mamba2-370m"), 1)
    assert list(mamba) == list(jmamba) == ["ln1", "ssm"]
    assert {k: d.shape for k, d in mamba["ssm"].items()} \
        == {k: d.shape for k, d in jmamba["ssm"].items()}


def _layer(params, i):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a)[i],
                                  params["blocks"])


def test_ssm_forward_and_state(model):
    jcfg, jrun, tcfg, _, params, tp_, _ = model
    rng = np.random.default_rng(3)
    for s in (24, 2):           # 2 < d_conv - 1: the ring's zero start
        x = bf16_np(rng, (2, s, jcfg.d_model))
        pl = tlm.layer_params(tp_, 1)["ssm"]
        ot, st = tssm.ssm_forward(tcfg, pl, to_torch(x), want_state=True)
        if s >= jcfg.ssm.d_conv - 1:
            oj, sj = jax.jit(lambda xx, pp: jssm.ssm_forward(
                jcfg, jrun, pp, xx, 1, want_state=True))(
                jnp.asarray(x), _layer(params, 1)["ssm"])
            close(ot, oj, 1e-2, 1e-2)
            close(st.h, sj.h, 1e-4, 1e-4)
            assert (bits(st.conv_x) == bits(sj.conv_x)).all()
            assert (bits(st.conv_bc) == bits(sj.conv_bc)).all()
        else:                   # the reference's slice needs s >= d_conv-1
            assert st.conv_x.shape[1] == jcfg.ssm.d_conv - 1
            assert (st.conv_x[:, :-s] == 0).all()


def test_ssm_decode_step(model):
    """Three recurrent steps from a prefilled state, the reference's state
    fed back each step: outputs, h and the (pre-activation) rings."""
    jcfg, jrun, tcfg, _, params, tp_, _ = model
    rng = np.random.default_rng(4)
    x = bf16_np(rng, (3, 12, jcfg.d_model))
    pj = _layer(params, 2)["ssm"]
    _, sj = jax.jit(lambda xx, pp: jssm.ssm_forward(
        jcfg, jrun, pp, xx, 1, want_state=True))(jnp.asarray(x), pj)
    step = jax.jit(lambda pp, xx, st: jssm.ssm_decode_step(jcfg, pp, xx, st,
                                                           1))
    pl = tlm.layer_params(tp_, 2)["ssm"]
    for t in range(3):
        xt = bf16_np(rng, (3, 1, jcfg.d_model))
        st = tssm.SSMState(*(to_torch(np.asarray(a)) for a in sj))
        oj, sj = step(pj, jnp.asarray(xt), sj)
        ot, new = tssm.ssm_decode_step(tcfg, pl, to_torch(xt), st)
        close(ot, oj, 1e-2, 1e-2)
        close(new.h, sj.h, 1e-4, 1e-4)
        assert (bits(new.conv_x) == bits(sj.conv_x)).all(), t
        assert (bits(new.conv_bc) == bits(sj.conv_bc)).all(), t
        # the in-place write under a mask keeps the masked-off row
        buf = tssm.SSMState(*(t_.clone() for t_ in st))
        tssm.write_state(buf, new, torch.tensor([True, False, True]))
        for b_, n_, o_ in zip(buf, new, st):
            assert torch.equal(b_[0], n_[0]) and torch.equal(b_[1], o_[1])


def test_hybrid_block(model):
    jcfg, jrun, tcfg, trun, params, tp_, _ = model
    rng = np.random.default_rng(5)
    x = bf16_np(rng, (2, 20, jcfg.d_model))
    pos = np.arange(20, dtype=np.int32)
    spec = jattn.base_attn_spec(jcfg)
    xj, cj, _ = shm(lambda xx, pp: jblocks.block_forward(
        jcfg, jrun, _layer(params, 1), xx, pp, spec, 1, window=16,
        want_cache=True), jnp.asarray(x), jnp.asarray(pos))
    xt, (kt, vt), st = tblocks.block_forward(
        tcfg, trun, tlm.layer_params(tp_, 1), to_torch(x),
        torch.as_tensor(pos), tattn.base_attn_spec(tcfg), window=16,
        want_cache=True)
    close(xt, xj, 1e-2, 1e-2)
    close(kt, cj["kv"][0], 1e-2, 1e-2)
    close(st.h, cj["ssm"].h, 1e-4, 1e-4)


def test_lm_forward_and_prefill(model):
    """The trunk within 1e-2 and the prefill's last-position logits within
    5e-3, with the per-layer SSM states the prefill keeps."""
    jcfg, jrun, tcfg, trun, params, tp_, dims = model
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    xj, _, _ = shm(lambda p, t: jlm.lm_forward(jcfg, jrun, p, t, 1, dims),
                   jp, jnp.asarray(toks))
    xt, _ = tlm.lm_forward(tcfg, trun, tp_, torch.as_tensor(toks))
    close(xt, xj, 1e-2, 2e-2)
    seen = []
    tlm.lm_forward(tcfg, trun, tp_, torch.as_tensor(toks), want_cache=True,
                   cache_fn=lambda i, kv, st: seen.append((i, st.h.shape)))
    assert seen == [(i, (2, 16, 8, 16)) for i in range(3)]
    lj, dj = shm(lambda p, t: jengine.prefill(jcfg, jrun, p, dims, t, 48, 1),
                 jp, jnp.asarray(toks))
    lt, dt = tengine.prefill(tcfg, trun, tp_, torch.as_tensor(toks), 48)
    v = jcfg.vocab_size
    np.testing.assert_allclose(lt.numpy()[..., :v], np.asarray(lj)[..., :v],
                               atol=5e-3)
    close(dt.ssm.h, dj.ssm.h, 1e-4, 1e-4)
    # layer 0's rings byte-equal; deeper layers' inputs differ from the
    # reference's by bf16 rounding (ROADMAP.md section 3, item 3)
    assert (bits(dt.ssm.conv_x[0]) == bits(dj.ssm.conv_x[0])).all()
    close(dt.ssm.conv_bc, dj.ssm.conv_bc, 1e-2, 1e-2)


def test_pack_ssm_leaves_byte_identical():
    """A hybrid wide enough that every bulk SSM leaf packs (``conv_x``
    (4, 1024) too): the port's store equals the reference's leaf for leaf,
    bytes and k; ``conv_x`` reaches the mixer through ``raw_weight`` (an
    exact decode) and the packed mixer equals the raw one.  The stacked
    ``gate_norm`` (4, 1024) stays raw in the port; the reference packs it
    (judged as one (L, d_inner) matrix)."""
    jcfg, tcfg = cfgs(n_layers=4, d_model=512, n_heads=4, n_kv_heads=4,
                      head_dim=128, d_ff=1024, attn_layout="full",
                      window=None)
    jrun = JRun(codec=JCodec(cache_block=4))
    params, _ = ref_params(jcfg, jrun, 2)
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=1, pod=1), jrun)
    jpk, _ = jweights.pack_serving_params(
        params, jparams.param_pspecs(table), tp=1)
    tpk = tweights.pack_serving_params(tparams.from_jax_params(params))
    js, ts = jpk["blocks"]["ssm"], tpk["blocks"]["ssm"]
    for name in ("w_zx", "w_bc", "w_dt", "w_out", "conv_x"):
        assert isinstance(ts[name], tweights.PackedWeight), name
        assert ts[name].k == js[name].k, name
        assert (bits(ts[name].signman) == bits(js[name].signman)).all()
        assert (bits(ts[name].planes) == bits(
            np.asarray(js[name].planes).view(np.int32))).all(), name
        assert (bits(ts[name].dict_syms) == bits(js[name].dict_syms)).all()
    for name in ("dt_bias", "a_log", "d_skip", "conv_bc", "gate_norm"):
        assert isinstance(ts[name], torch.Tensor), name
    assert hasattr(js["gate_norm"], "signman")       # the reference's choice
    raw = tparams.from_jax_params(params)
    x = to_torch(bf16_np(np.random.default_rng(7), (1, 9, 512)))
    o_raw, s_raw = tssm.ssm_forward(tcfg, tlm.layer_params(raw, 0)["ssm"], x,
                                    want_state=True)
    o_pk, s_pk = tssm.ssm_forward(tcfg, tlm.layer_params(tpk, 0)["ssm"], x,
                                  want_state=True)
    assert torch.equal(o_raw, o_pk) and torch.equal(s_raw.h, s_pk.h)
