"""The fixed loop's stub-input families at tp = 2: the port on two
spawned gloo ranks (``launch.mesh.spawn`` running ``launch.tp_jobs``,
which imports no JAX) against the reference at tp = 2 on two of
conftest's fake devices, with the same weights (the whole tree, cut to
each rank's shard), on

- the reference tests' encoder-decoder (``tests/test_decode.py``'s
  "encdec": 2 + 2 layers, d 64, 4/4 heads, hd 16; block 4) in ``col``
  mode, and a ``row``-mode one (2 query heads, 1 kv head: hq / tp = n_kv
  = 1, the one row shape whose cross store the reference's layout holds,
  ``ROADMAP.md`` section 3, item 8);
- a tiny vision-stub VLM whose 12 front tokens span both shards of a
  16-token prompt.

Each checks: the encoder's memory on every rank within bf16 rounding of
the reference's, and the bytes of its LEXI-packed gather the reference's
``fixed.compress`` of the rank's shard (so the wire and raw byte counts
are the reference's); each rank's cross-attention store, filled from the
reference's memory, byte for byte the reference's; teacher-forced
prefill and decode logits within 5e-3; greedy streams equal up to the
near-tie rule (``ROADMAP.md`` section 3, item 2); the wire counters by
kind (``encoder``, ``memory``, ``cross``, ``all_gather``); the launcher's
``--tp 2`` fixed loop for reduced seamless-m4t-large-v2 and internvl2-76b
printing tp = 1's continuations; and, on the host alone, the front
embeddings' shard rule wherever the front tokens end."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig, ModelConfig as JModel
from repro.configs.base import RunConfig as JRun
from repro.core import collectives as jcl, fixed as jfixed
from repro.core.collectives import CodecConfig as JCodec
from repro.models import blocks as jblocks, layers as jlayers, lm as jlm
from repro.models import params as JPM
from repro.serve import engine as jengine
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.launch import mesh, tp_jobs
from repro_torch.launch.mesh import TPGroup
from repro_torch.models import lm as tlm, params as tparams
from torch_tp_ref import pair, ref_fixed, tree_np

torch.set_num_threads(2)

TP, BLK, MAXLEN = 2, 4, 64
B, S, SM, NDEC = 3, 16, 22, 8     # 22 frames: 11 rows a rank, 3 in a ring
ROOT = Path(__file__).resolve().parents[1]
ENC = dict(name="e", family="encdec", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=4, d_ff=128, vocab_size=500, head_dim=16, encdec=True,
           frontend="audio_stub")
CASES = {"col": ENC, "row": dict(ENC, n_heads=2, n_kv_heads=1),
         "vlm": dict(name="v", family="vlm", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=500,
                     head_dim=16, frontend="vision_stub",
                     n_frontend_tokens=12)}
ENCS = ("col", "row")
# ``ROADMAP.md`` section 3, item 8: the reference's row-mode cross store
# errs with 6 heads over 3 and fails with 4 over 1
FAULT = dict(ENC, n_heads=6, n_kv_heads=3)
JRUN = JRun(codec=JCodec(cache_block=BLK))
TRUN = TRun(codec=TCodec(cache_block=BLK))
FIELDS = ("signman", "planes", "dict_syms", "esc_pos", "esc_raw", "ring")
ARCHS = ("seamless-m4t-large-v2", "internvl2-76b")


def _inputs(case):
    """Prompts (B, S) and the case's stub input, numpy."""
    rng = np.random.default_rng(list(CASES).index(case))
    prompts = rng.integers(0, 500, (B, S)).astype(np.int32)
    if case == "vlm":
        shape, key = (B, CASES[case]["n_frontend_tokens"], 64), \
            "front_embeds"
    else:
        shape, key = (B, SM, 64), "enc_embeds"
    return prompts, {key: rng.normal(0, 1, shape).astype(ml_dtypes.bfloat16)}


def _ref_encoder(jcfg, params, prompts, enc):
    """The reference at tp = 2: each rank's cross-attention store after
    its prefill, the memory its ``lm_forward`` gathers (the encoder trunk
    on the rank's contiguous frames, ``enc_norm``, the LEXI gather) and
    each decoder layer's cross-attention (k, v) of that memory as its
    ``cross_attn_forward`` returns them to the store: (xkv, kv, with a
    leading rank axis; memory (B, SM, D))."""
    mesh_ = jax.make_mesh((1, TP), ("data", "model"))
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=TP, pod=1), JRUN)
    dims = jlm.lm_fsdp_dims(table)

    def body(pp, toks, e):
        _, st = jengine.prefill(jcfg, JRUN, pp, dims, toks, MAXLEN, TP,
                                enc_embeds=e)
        sm_loc = SM // TP
        ex = jax.lax.dynamic_slice_in_dim(
            e, jax.lax.axis_index("model") * sm_loc, sm_loc, axis=1)
        spec = jlayers.AttnSpec(causal=False, softcap=jcfg.attn_softcap)
        ex, _, _ = jlm._scan_blocks(jcfg, JRUN, pp["enc_blocks"],
                                    dims["enc_blocks"],
                                    ex.astype(jnp.bfloat16),
                                    jnp.arange(SM, dtype=jnp.int32), spec,
                                    TP)
        ex = jlayers.rms_norm(ex, pp["enc_norm"], jcfg.norm_eps)
        mem = jcl.lexi_all_gather(ex, "model", JRUN.codec, gather_axis=1)
        pos = jnp.arange(SM, dtype=jnp.int32)
        kvs = [jblocks.cross_attn_forward(
            jcfg, JRUN, jax.tree_util.tree_map(lambda a: a[i],
                                               pp["blocks"]["xattn"]),
            mem[:, :1], mem, pos[:1], pos,
            jlayers.AttnSpec(causal=False, softcap=None), TP,
            want_cache=True)[1] for i in range(jcfg.n_layers)]
        lead = lambda t: t[None]
        return jax.tree_util.tree_map(lead, (st.xkv, kvs)), mem[None]

    f = jax.jit(jcl.shmap(body, mesh_, (JPM.param_pspecs(table),
                                        P(None, None), P()),
                          (P("model"), P("model"))))
    (xkv, kvs), mem = f(jax.tree_util.tree_map(jnp.asarray, params),
                        jnp.asarray(prompts), jnp.asarray(enc))
    return jax.tree_util.tree_map(np.asarray, (xkv, kvs)), np.asarray(mem)[0]


def _ref_wire(x: np.ndarray) -> np.ndarray:
    """The reference's ``fixed.compress`` of one gather part, its fields
    back to back (the port's wire layout)."""
    ct = jfixed.compress(jnp.asarray(x), k=JRUN.codec.k,
                         esc_capacity=JRUN.codec.esc_capacity(x.size))
    return np.concatenate([np.asarray(f).reshape(-1).view(np.uint8) for f in
                           (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos,
                            ct.esc_raw, ct.n_escapes)])


def _launch(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--batch", "2", "--prompt-len", "16",
         "--new-tokens", "4", "--tp", "2", "--dist-backend", "gloo"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    return out.returncode, out.stdout, out.stderr


@pytest.fixture(scope="module")
def served():
    """The reference's greedy loops, then every port job on one spawn of
    two ranks -- the fixed loop teacher-forced with the reference's
    stream, the encoders fed the reference's memory -- run in a thread
    beside the reference's state and the launcher's subprocesses."""
    ref, params, calls = {}, {}, []
    for seed, case in enumerate(CASES):
        jcfg, tcfg = JModel(**CASES[case]), TModel(**CASES[case])
        params[case] = tree_np(tparams.init_params(
            tlm.lm_table(tcfg, TP), torch.Generator().manual_seed(seed + 1)))
        prompts, extras = _inputs(case)
        ref[case] = dict(loop=ref_fixed(jcfg, JRUN, TP, params[case],
                                        prompts, NDEC, MAXLEN,
                                        extras=extras))
    for case in CASES:
        prompts, extras = _inputs(case)
        calls.append(("fixed", (TModel(**CASES[case]), TRUN, prompts, NDEC,
                                MAXLEN, dict(
                                    params=params[case],
                                    forced=ref[case]["loop"][0][:, :NDEC],
                                    **{k: pair(v) for k, v in
                                       extras.items()}))))
    # the fault's probe: tp = 1's greedy loop, its tokens fed to tp = 2
    params["fault"] = tree_np(tparams.init_params(
        tlm.lm_table(TModel(**FAULT), TP), torch.Generator().manual_seed(9)))
    prompts, extras = _inputs("col")
    ref["fault"] = ref_fixed(JModel(**FAULT), JRUN, 1, params["fault"],
                             prompts, NDEC, MAXLEN, extras=extras)
    forced = ref["fault"][0][:, :NDEC]
    ref["fault_tp2"] = ref_fixed(JModel(**FAULT), JRUN, TP, params["fault"],
                                 prompts, NDEC, MAXLEN, feed=forced,
                                 extras=extras)[1]
    calls.append(("fixed", (TModel(**FAULT), TRUN, prompts, NDEC, MAXLEN,
                            dict(params=params["fault"], forced=forced,
                                 **{k: pair(v) for k, v in
                                    extras.items()}))))
    with ThreadPoolExecutor(3) as pool:
        launch = [pool.submit(_launch, a) for a in ARCHS]
        for case in ENCS:
            prompts, extras = _inputs(case)
            (ref[case]["xkv"], kvs), ref[case]["memory"] = _ref_encoder(
                JModel(**CASES[case]), params[case], prompts,
                extras["enc_embeds"])
            kvs = [[(pair(k[r]), pair(v[r])) for k, v in kvs]
                   for r in range(TP)]
            calls.append(("encoder", (
                TModel(**CASES[case]), TRUN, pair(extras["enc_embeds"]),
                kvs, MAXLEN, dict(params=params[case]))))
        ranks = mesh.spawn(tp_jobs.batch, TP, backend="gloo", args=(calls,))
        ref["launch"] = [f.result() for f in launch]
    return ref, ranks


def _job(case, kind):
    return list(CASES).index(case) if kind == "fixed" \
        else len(CASES) + 1 + ENCS.index(case)


def _bf(a):
    return a[1].view(ml_dtypes.bfloat16).astype(np.float32) \
        if isinstance(a, tuple) else np.asarray(a)


@pytest.mark.parametrize("case", ENCS)
def test_memory_and_its_gather(served, case):
    """Every rank holds the same memory, within bf16 rounding of the
    reference's (the encoder's f32 sums run in another order: ``ROADMAP``
    section 3, item 7); the memory crossed LEXI-packed, each rank's part
    the reference's ``fixed.compress`` of its shard, byte for byte, so its
    wire bytes are the reference's."""
    ref, ranks = served
    mems = [_bf(ranks[r][_job(case, "enc")]["memory"]) for r in range(TP)]
    assert (mems[0] == mems[1]).all()
    want = ref[case]["memory"].astype(np.float32)
    np.testing.assert_allclose(mems[0], want, rtol=1e-2, atol=1e-2)
    sm_loc = SM // TP
    for r in range(TP):
        shard = mems[0][:, r * sm_loc:(r + 1) * sm_loc].astype(
            ml_dtypes.bfloat16)
        wire = ranks[r][_job(case, "enc")]["wire"]
        assert wire.shape[0] == 1
        assert (wire[0] == _ref_wire(shard)).all(), r
        assert wire.shape[1] == len(_ref_wire(
            ref[case]["memory"][:, r * sm_loc:(r + 1) * sm_loc]))
        assert wire.shape[1] < shard.size * 2


@pytest.mark.parametrize("case", ENCS)
def test_cross_store_byte_identical_per_rank(served, case):
    """From the reference's K/V of the memory (its ``cross_attn_forward``
    on each rank: the rank's kv heads in ``col`` mode, all of them in
    ``row`` mode; the port's own differ by the rounding of f32 sums run in
    another order, as item 3 of ``ROADMAP.md`` section 3 has it for deeper
    layers' K/V), every decoder layer's cross store on each rank -- its
    11 interleaved rows, 2 full blocks compressed, 3 rows in the ring:
    ``col`` mode's all-to-all of heads, ``row`` mode's slice -- equals the
    reference rank's ``xkv`` byte for byte; the port's own prefill fills
    stores of the same layout."""
    ref, ranks = served
    jxkv = ref[case]["xkv"]
    for r in range(TP):
        got = ranks[r][_job(case, "enc")]["xkv"]
        own = ranks[r][_job(case, "fixed")]["xkv"]
        for i in range(CASES[case]["n_layers"]):
            for f in FIELDS:
                want = np.asarray(getattr(jxkv, f))[r, i]
                assert got[i][f].shape == want.shape, (r, i, f)
                assert (got[i][f].view(np.uint8)
                        == want.view(np.uint8)).all(), (case, r, i, f)
                assert own[i][f].shape == want.shape


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_streams(served, case):
    """Teacher-forced with the reference's greedy stream, the prefill and
    every decode step's logits within 5e-3 of the reference's tp = 2; the
    port's own greedy stream equal on both ranks and to the reference's
    up to the first step whose reference top-2 margin is within 1e-2."""
    ref, ranks = served
    want, logits = ref[case]["loop"]
    got = ranks[0][_job(case, "fixed")]
    assert (ranks[1][_job(case, "fixed")]["tokens"] == got["tokens"]).all()
    np.testing.assert_allclose(got["logits"][..., :500], logits[..., :500],
                               atol=5e-3)
    top2 = np.sort(logits[..., :500], -1)[..., -2:]
    near_tie = ((top2[..., 1] - top2[..., 0]) <= 1e-2).T     # (B, n + 1)
    for b in range(B):
        diff = np.flatnonzero(got["tokens"][b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (case, b, diff[0])


@pytest.mark.parametrize("case", list(CASES))
def test_wire_kinds(served, case):
    """The prefill's compressed gathers by kind: each encoder layer's
    mixer and MLP entries (``encoder``), the memory once (``memory``),
    each decoder layer's cross-attention entry (``cross``) beside its
    mixer and MLP entries (``all_gather``); packed below raw, no escape
    overflow; the same on both ranks."""
    _, ranks = served
    kinds = ranks[0][_job(case, "fixed")]["wire"]["kinds"]
    assert kinds == ranks[1][_job(case, "fixed")]["wire"]["kinds"]
    n = CASES[case]["n_layers"]
    want = {"all_gather": 2 * n}
    if case != "vlm":
        want.update(encoder=2 * n, memory=1, cross=n)
    assert {k: v["calls"] for k, v in kinds.items()} == want
    for k, v in kinds.items():
        assert 0 < v["wire_bytes"] < v["raw_bytes"] and v["overflows"] == 0
    if case != "vlm":
        assert kinds["memory"]["raw_bytes"] == B * SM // TP * 64 * 2


def test_row_mode_store_fault(served):
    """``ROADMAP.md`` section 3, item 8: with 6 query heads over 3 kv
    heads (``row`` mode at tp = 2), the reference's tp = 2 decode reads
    other heads than its store holds and leaves tp = 1's function (its
    logits fed tp = 1's tokens more than 0.1 away), while the port's tp =
    2 stores every kv head and stays within 5e-3 of the reference's tp =
    1; with 4 over 1 the reference's prefill cannot store its picks."""
    ref, ranks = served
    tp1 = ref["fault"][1][..., :500]
    assert np.abs(ref["fault_tp2"][..., :500] - tp1).max() > 0.1
    got = ranks[0][len(CASES)]["logits"][..., :500]
    np.testing.assert_allclose(got, tp1, atol=5e-3)
    prompts, extras = _inputs("col")
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        ref_fixed(JModel(**dict(ENC, n_kv_heads=1)), JRUN, TP, tree_np(
            tparams.init_params(tlm.lm_table(TModel(**dict(
                ENC, n_kv_heads=1)), TP), torch.Generator().manual_seed(9))),
            prompts, 1, MAXLEN, extras=extras)


@pytest.mark.parametrize("nf", [4, 8, 12, 16])
def test_front_embeds_shard_rule(nf):
    """``lm.front_embed`` on each rank's shard of a 16-token prompt at tp
    = 2 is that shard of the tp = 1 result, wherever the front tokens end:
    inside shard 0, at its end, inside shard 1, filling both."""
    cfg = TModel(**dict(CASES["vlm"], n_frontend_tokens=nf))
    rng = np.random.default_rng(nf)
    x = torch.as_tensor(rng.normal(0, 1, (2, 16, 64))).to(torch.bfloat16)
    fe = torch.as_tensor(rng.normal(0, 1, (2, nf, 64))).to(torch.bfloat16)
    whole = tlm.front_embed(cfg, x, fe)
    assert torch.equal(whole[:, :nf], fe) and torch.equal(whole[:, nf:],
                                                          x[:, nf:])
    for r in range(TP):
        tg = TPGroup(r, TP, "gloo", torch.device("cpu"))
        got = tlm.front_embed(cfg, x[:, r * 8:(r + 1) * 8], fe, tg)
        assert torch.equal(got, whole[:, r * 8:(r + 1) * 8]), (nf, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_fixed_loop_at_tp2(served, arch):
    """``launch.serve --arch ... --tp 2 --dist-backend gloo`` serves
    reduced seamless and internvl2 on the fixed loop, every rank drawing
    the same stub inputs after the prompts, and prints the tp = 1
    continuations (both are dense trunks: the same function at every
    tp)."""
    from repro_torch.configs import get_config, make_reduced
    from repro_torch.launch import serve
    from repro_torch.serve import engine as tengine

    ref, _ = served
    code, out, err = ref["launch"][ARCHS.index(arch)]
    assert code == 0, err[-3000:]
    assert "tp 2" in out
    printed = out.split("sample continuations: ")[-1].strip()
    cfg = make_reduced(get_config(arch))
    run = TRun(codec=TCodec(cache_block=32))
    params = tparams.init_params(tlm.lm_table(cfg),
                                 torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)),
                              dtype=torch.int32)
    extras = serve.stub_inputs(cfg, rng, 2, 16, "cpu")
    want = tengine.generate(cfg, run, params, prompts, 4, 16 + 4 + 32,
                            **extras)
    assert printed == str(want[:2, :12].tolist())
