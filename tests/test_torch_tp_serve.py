"""Serving at tp = 2: the port's ``ServeEngine(tp=2)`` and fixed-batch loop
on two spawned gloo ranks (``launch.mesh.spawn`` running
``launch.tp_jobs``, which imports no JAX) against the reference's
``ServeEngine(tp=2)`` and its ``prefill`` + ``decode_step`` under
``shmap`` on two of conftest's fake devices, with the reference's weights
(the whole tree, cut to each rank's shard by ``models.params.
shard_params``):

* greedy streams and stop reasons equal to the reference's, both ranks
  alike, for dense GQA 8:4 (``col`` kv mode) and MQA 3:1 (``row`` mode,
  its query heads padded to 4), codec on and off, with prefix sharing on
  a mix with shared prefixes (the reference's hit counts too); a request
  may part from the reference only at a near-tie of the reference's own
  logits (``_check_streams``; at most one request of the mix), the rule
  the fixed loop is held to at tp = 1;
* packed weights: the streams equal the reference's packed tp = 2 stream,
  and every rank's packed leaves are the reference's
  ``pack_serving_params(..., tp=2)`` shards byte for byte;
* the fixed loop held as ``test_torch_fixed.py`` holds tp = 1:
  teacher-forced logits within 5e-3, streams equal up to the first
  reference top-2 margin within 1e-2;
* the launcher, ``--tp 2 --dist-backend gloo --device cpu``, in both
  modes: the continuations of tp = 1 (the same seeded model: the tp = 1
  weights padded for tp are the same function).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig
from repro.configs.base import ModelConfig as JModel
from repro.configs.base import RunConfig as JRun
from repro.core import collectives as jcl
from repro.core.collectives import CodecConfig as JCodec
from repro.launch.disagg_host import tiny_bench_config
from repro.models import lm as jlm, params as JPM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve import engine as jengine
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.launch import mesh, tp_jobs

torch.set_num_threads(2)

TP, MAXLEN, SLOTS, BLK = 2, 48, 2, 4
ROOT = Path(__file__).resolve().parents[1]


def _cfg_kw(name):
    kw = dataclasses.asdict(tiny_bench_config())
    if name == "mqa":
        kw.update(name="mqa", n_heads=3, n_kv_heads=1)
    return kw


def _runs(codec_on):
    jc = JCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=BLK)
    tc = TCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=BLK)
    return JRun(codec=jc), TRun(codec=tc)


def _mix(vocab):
    """(prompt, budget): trunks with replayed tails, a tail that crosses
    a page, a prompt shorter than a page column, more requests than
    slots, and a duplicate and a fork of a 24-token prompt (hits on its
    first two columns of 8 tokens)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, vocab, (24,)).astype(np.int32)
    out = [(rng.integers(0, vocab, (s,)).astype(np.int32), b)
           for s, b in [(8, 5), (13, 6), (4, 9)]]
    out += [(a, 4), (a.copy(), 3),
            (np.concatenate([a[:16], rng.integers(0, vocab, (5,))
                             .astype(np.int32)]), 5), (a.copy(), 2)]
    return out


CACHE_STATS = ("cache_hot_hits", "cache_spilled_pages", "cache_spilled_bytes",
               "cache_fetched_pages", "cache_fetched_bytes",
               "cache_reprefill_cols", "cache_evicted_cols")


def _pressure_mixes(vocab):
    """Nine 24-token prompts (3 pages a rank each) in waves of two fill
    the pool with retained prefix pages, so the later waves evict the
    first's columns (spilled at release); then the first prompt again,
    alone, restores them from the warm tier."""
    rng = np.random.default_rng(5)
    ps = [rng.integers(0, vocab, (24,)).astype(np.int32) for _ in range(9)]
    return [(p, 2) for p in ps], [(ps[0].copy(), 3)]


CASES = {"gqa-codec": ("gqa", True), "gqa-raw": ("gqa", False),
         "mqa-codec": ("mqa", True), "mqa-raw": ("mqa", False)}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _ref_forced(jcfg, jrun, params, prompts, feed, max_len):
    """The reference's fixed loop at tp = 2 fed ``feed`` (B, n): the
    whole-vocab logits (n + 1, B, V) of the prefill and of each step."""
    mesh_ = jax.make_mesh((1, TP), ("data", "model"))
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=TP, pod=1), jrun)
    dims = jlm.lm_fsdp_dims(table)
    pspecs = JPM.param_pspecs(table)
    n = feed.shape[1]

    def forced(pp, toks, fd):
        lg, st = jengine.prefill(jcfg, jrun, pp, dims, toks, max_len, TP)
        outs = [lg]
        for t in range(n):
            lg, st = jengine.decode_step(jcfg, jrun, pp, dims, st,
                                         fd[:, t:t + 1], TP)
            outs.append(lg)
        return jnp.stack(outs)[:, :, 0]

    fj = jax.jit(jcl.shmap(forced, mesh_, (pspecs, P(None, None),
                                           P(None, None)),
                           P(None, None, "model")))
    return np.asarray(fj(params, jnp.asarray(prompts), jnp.asarray(feed)))


def _margins(logits, v):
    top2 = np.sort(logits[..., :v], -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _ref_fixed(jcfg, jrun, params, prompts, n, max_len):
    """The reference's fixed loop at tp = 2: greedy tokens (B, n + 1),
    and the whole-vocab logits of the same loop fed those tokens."""
    mesh_ = jax.make_mesh((1, TP), ("data", "model"))
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=TP, pod=1), jrun)
    dims = jlm.lm_fsdp_dims(table)
    pspecs = JPM.param_pspecs(table)

    def stream(pp, toks):
        lg, st = jengine.prefill(jcfg, jrun, pp, dims, toks, max_len, TP)
        tok = jengine.greedy_token(jcfg, lg, TP)
        outs = [tok]
        for _ in range(n):
            lg, st = jengine.decode_step(jcfg, jrun, pp, dims, st, tok, TP)
            tok = jengine.greedy_token(jcfg, lg, TP)
            outs.append(tok)
        return jnp.concatenate(outs, 1)

    sj = jax.jit(jcl.shmap(stream, mesh_, (pspecs, P(None, None)),
                           P(None, None)))
    want = np.asarray(sj(params, jnp.asarray(prompts)))
    return want, _ref_forced(jcfg, jrun, params, prompts, want[:, :n],
                             max_len)


@pytest.fixture(scope="module")
def served():
    """The reference's runs, then every port job on one spawn of two
    ranks."""
    ref, calls = {}, []
    for case, (name, codec_on) in sorted(CASES.items()):
        kw = _cfg_kw(name)
        jcfg, tcfg = JModel(**kw), TModel(**kw)
        jrun, trun = _runs(codec_on)
        je = JEngine(jcfg, jrun, tp=TP, n_slots=SLOTS, max_len=MAXLEN,
                     seed=1, max_fuse_steps=1)
        mix = _mix(jcfg.vocab_size)
        reqs = [dict(uid=i, prompt=p, max_new_tokens=b)
                for i, (p, b) in enumerate(mix)]
        res, st = je.run([JRequest(**r) for r in reqs])
        ref[case] = dict(streams=[(list(r.tokens), r.stop_reason)
                                  for r in res],
                         hits=st.shared_page_hits, mix=mix, cfg=jcfg,
                         cache={k: getattr(st, k) for k in CACHE_STATS},
                         run=jrun, params=_np_tree(je.params))
        then = []
        if case == "gqa-codec":        # pool pressure, then a warm restore
            for mix2 in _pressure_mixes(jcfg.vocab_size):
                then.append([dict(uid=10 + len(then) * 10 + i, prompt=p,
                                  max_new_tokens=b)
                             for i, (p, b) in enumerate(mix2)])
                res, st = je.run([JRequest(**r) for r in then[-1]])
            ref["restore"] = dict(
                streams=[(list(r.tokens), r.stop_reason) for r in res],
                cache={k: getattr(st, k) for k in CACHE_STATS})
        calls.append(("serve", (tcfg, trun, reqs, dict(
            params=ref[case]["params"], then=then,
            engine=dict(n_slots=SLOTS, max_len=MAXLEN,
                        max_fuse_steps=1)))))
    # packed weights: the reference packs its whole tree at tp = 2 (its
    # weight backend resolves to the exact unpack-then-einsum on the CPU)
    kw = _cfg_kw("gqa")
    jcfg, tcfg = JModel(**kw), TModel(**kw)
    jrun, trun = _runs(True)
    raw_params = ref["gqa-codec"]["params"]
    pk = JEngine(jcfg, jrun, tp=TP, n_slots=SLOTS, max_len=MAXLEN,
                 params=jax.tree_util.tree_map(jnp.asarray, raw_params),
                 compress_weights=True, max_fuse_steps=1)
    reqs = [dict(uid=i, prompt=p, max_new_tokens=b)
            for i, (p, b) in enumerate(_mix(jcfg.vocab_size)[:4])]
    res, _ = pk.run([JRequest(**r) for r in reqs])
    ref["packed"] = dict(streams=[(list(r.tokens), r.stop_reason)
                                  for r in res],
                         params=_np_tree(pk.params),
                         specs=pk._pspecs)
    calls.append(("serve", (tcfg, trun, reqs, dict(
        params=raw_params, packed_leaves=True,
        engine=dict(n_slots=SLOTS, max_len=MAXLEN,
                    compress_weights=True)))))
    # the fixed loop
    s, n = 10, 8
    max_len = s + n + BLK * TP
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (3, s)).astype(np.int32)
    fixed = {}
    for name in ("gqa", "mqa"):
        kw = _cfg_kw(name)
        jcfg, tcfg = JModel(**kw), TModel(**kw)
        jrun, trun = _runs(True)
        table = jlm.lm_table(jcfg, MeshConfig(data=1, model=TP, pod=1), jrun)
        params = JPM.init_params(table, jax.random.key(2))
        want, logits = _ref_fixed(jcfg, jrun, params, prompts, n, max_len)
        fixed[name] = dict(want=want, logits=logits, vocab=jcfg.vocab_size)
        calls.append(("fixed", (tcfg, trun, prompts, n, max_len, dict(
            params=_np_tree(params), forced=want[:, :n]))))
    ranks = mesh.spawn(tp_jobs.batch, TP, backend="gloo", args=(calls,))
    return ref, fixed, ranks


def _check_streams(ref_case, got, want):
    """Streams equal; a request may part from the reference only at a
    near-tie: where the reference's top-2 margin, teacher-forced with its
    own stream, is within 1e-2 (twice the 5e-3 gap between the two
    packages' logits: f32 sums in prefill run in another order)."""
    parted = 0
    for (g, gw), (w, ww), (prompt, _) in zip(got, want, ref_case["mix"]):
        if (g, gw) == (w, ww):
            continue
        j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        trunk = len(prompt) // TP * TP       # then the tail, then w[:j]
        feed = np.concatenate([prompt[trunk:], np.asarray(w[:j], np.int32)])
        logits = _ref_forced(ref_case["cfg"], ref_case["run"],
                             ref_case["params"], prompt[None, :trunk],
                             feed[None], len(prompt) + j + BLK * TP)
        margin = _margins(logits[len(prompt) - trunk + j, 0],
                          ref_case["cfg"].vocab_size)
        assert margin <= 1e-2, (j, g, w, margin)
        parted += 1
    return parted


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_equal_the_reference(served, case):
    ref, _, ranks = served
    i = sorted(CASES).index(case)
    got = ranks[0][i]["runs"][0]["streams"]
    for r in range(TP):
        run = ranks[r][i]["runs"][0]
        assert run["streams"] == got, r            # every rank alike
        assert run["stats"]["shared_page_hits"] == ref[case]["hits"]
        # the tiered PageCache's counters: every rank's payloads spilled
        assert {k: run["stats"][k] for k in CACHE_STATS} \
            == ref[case]["cache"]
        assert ranks[r][i]["pages_in_use"] > 0     # retained prefix pages
    got = [(list(t), why) for t, why in got]
    parted = _check_streams(ref[case], got, ref[case]["streams"])
    assert parted <= 1, parted
    assert ref[case]["hits"] > 0                    # sharing did fire
    if CASES[case][1]:                              # activations compressed
        w = ranks[0][i]["runs"][0]["wire"]
        assert 0 < w["wire_bytes"] < w["raw_bytes"] and w["overflows"] == 0


def test_warm_tier_restores_under_pool_pressure(served):
    """The gqa-codec engine's further mixes: retained columns evicted
    under pool pressure, then restored from every rank's spilled payloads
    (a warm import on each rank of its own shard's pages): the streams
    and the PageCache's counters (cumulative) equal the reference's."""
    ref, _, ranks = served
    i = sorted(CASES).index("gqa-codec")
    want = ref["restore"]
    assert want["cache"]["cache_evicted_cols"] > 0
    assert want["cache"]["cache_fetched_pages"] > 0
    for r in range(TP):
        run = ranks[r][i]["runs"][2]
        assert [(list(t), why) for t, why in run["streams"]] \
            == want["streams"]
        assert {k: run["stats"][k] for k in CACHE_STATS} == want["cache"]


def test_packed_streams_equal_the_reference(served):
    ref, _, ranks = served
    i = len(CASES)
    got = [(list(t), why) for t, why in ranks[0][i]["runs"][0]["streams"]]
    assert _check_streams(ref["gqa-codec"], got, ref["packed"]["streams"]) \
        <= 1
    raw = [(list(t), why) for t, why in
           ranks[0][sorted(CASES).index("gqa-codec")]["runs"][0]["streams"]]
    assert got == raw[:len(got)]          # packing changes no stream
    for r in range(TP):
        run = ranks[r][i]["runs"][0]
        assert run["streams"] == ranks[0][i]["runs"][0]["streams"]
        assert run["stats"]["weights_compressed"]
        assert run["stats"]["weight_bytes_per_step"] \
            < run["stats"]["weight_raw_bytes_per_step"]


def test_packed_leaves_are_the_reference_shards(served):
    """Each rank's PackedWeight leaves are the reference's packed whole
    leaves cut along their PartitionSpec's model dim, byte for byte (one
    dictionary and code width per slice, from the whole leaf)."""
    ref, _, ranks = served
    i = len(CASES)
    params, specs = ref["packed"]["params"], ref["packed"]["specs"]
    n_leaves = 0
    for path, fields in ranks[0][i]["packed"].items():
        node, spec = params, specs
        for key in path.split("/"):
            node, spec = node[key], spec[key]
        assert int(node.k) == fields["k"], path
        for f in ("signman", "planes", "dict_syms"):
            whole = np.asarray(getattr(node, f))
            sp = tuple(getattr(spec, f))
            sp = sp + (None,) * (whole.ndim - len(sp))
            for r in range(TP):
                part = whole
                if "model" in sp:
                    part = np.split(whole, TP, axis=sp.index("model"))[r]
                got = ranks[r][i]["packed"][path][f]
                assert got.shape == part.shape, (path, f)
                assert (got.view(np.uint8) == part.view(np.uint8)).all(), \
                    (path, f, r)
        n_leaves += 1
    assert n_leaves >= 4


@pytest.mark.parametrize("name", ["gqa", "mqa"])
def test_fixed_loop_matches_reference(served, name):
    """Teacher-forced logits within 5e-3; the greedy streams equal the
    reference's up to its first top-2 margin within 1e-2."""
    _, fixed, ranks = served
    i = len(CASES) + 1 + ["gqa", "mqa"].index(name)
    want, logits, v = (fixed[name][k] for k in ("want", "logits", "vocab"))
    got0 = ranks[0][i]
    for r in range(TP):
        assert (ranks[r][i]["tokens"] == got0["tokens"]).all()
    np.testing.assert_allclose(got0["logits"][..., :v], logits[..., :v],
                               atol=5e-3)
    top2 = np.sort(logits[..., :v], -1)[..., -2:]
    near_tie = ((top2[..., 1] - top2[..., 0]) <= 1e-2).T     # (B, n + 1)
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got0["tokens"][b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0])


def _launch(*args):
    """The launcher in a subprocess (a spawning main must be a module)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--device", "cpu", *args], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return [ln for ln in out.stdout.splitlines() if "sample" in ln]


def _launch_here(capsys, *args):
    """The launcher at tp = 1 in this process."""
    from repro_torch.launch import serve as launcher
    assert launcher.main(["--device", "cpu", *args]) == 0
    return [ln for ln in capsys.readouterr().out.splitlines()
            if "sample" in ln]


@pytest.mark.parametrize("mode", [
    ["--batch", "2", "--prompt-len", "16", "--new-tokens", "4"],
    ["--continuous", "--requests", "3", "--slots", "2", "--prompt-len",
     "16", "--new-tokens", "3", "--compress-weights"]],
    ids=["fixed", "continuous"])
def test_launcher_tp2(mode, capsys):
    tp2 = _launch("--tp", "2", "--dist-backend", "gloo", *mode)
    assert tp2 and tp2 == _launch_here(capsys, *mode)


def test_launcher_refuses(capsys):
    """The launcher's argument errors at tp, before any rank spawns (every
    family serves at tp > 1: ``test_torch_tp_{encdec,ssm_only}.py``)."""
    from repro_torch.launch import serve as launcher
    for args, msg in ((["--tp", "2"], "dist-backend"),
                      (["--tp", "0", "--arch", "mamba2-370m"], ">= 1")):
        with pytest.raises(SystemExit):
            launcher.main(["--device", "cpu", *args])
        assert msg in capsys.readouterr().err


def test_configs_at_tp_match_the_reference():
    """``padded_heads``, ``padded_vocab`` and ``make_reduced(cfg, tp=)``
    at tp 2 and 4, every config, as the reference computes them."""
    from repro.configs import get_config as jget, make_reduced as jred
    from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS
    from repro_torch.configs import get_config as tget, make_reduced as tred

    for name in sorted(set(ASSIGNED_ARCHS) | set(PAPER_ARCHS)):
        j, t = jget(name), tget(name)
        for tp in (2, 4):
            assert t.padded_heads(tp) == j.padded_heads(tp), (name, tp)
            assert t.padded_vocab(tp) == j.padded_vocab(tp), (name, tp)
            assert repr(tred(t, tp=tp)) == repr(jred(j, tp=tp)), (name, tp)


def _engine_tp2(cfg, run, group, **kw):
    from repro_torch.serve.scheduler import ServeEngine
    return ServeEngine(cfg, run, tp=2, group=group, device="cpu", **kw)


def test_tp_refusals():
    """What tp > 1 does not serve raises, before any collective: CUDA
    graphs, a missing or mismatched group, and ``ServeEngine`` on the
    encoder-decoder and the VLM (the reference's error: they serve on the
    fixed loop only, at every tp); and the scheduler refuses prompts
    shorter than tp.  MoE, SSM and MLA configs build (each rank holding
    its experts, its SSM heads, its MLA query heads), and so do the
    encoder-decoder's, the VLM's and the attention-free model's tables at
    tp = 2 (the attention-free engine with no page pool)."""
    from repro_torch.configs import get_config, make_reduced
    from repro_torch.models import lm
    from repro_torch.launch.mesh import TPGroup
    from repro_torch.serve.scheduler import Request as TReq
    from repro_torch.serve.scheduler import RequestScheduler

    cpu = torch.device("cpu")
    tg = TPGroup(0, 2, "gloo", cpu)
    _, trun = _runs(True)
    moe = make_reduced(get_config("granite-moe-1b-a400m"), tp=2)
    eng = _engine_tp2(moe, trun, tg)
    assert eng.params["blocks"]["moe"]["w_gate"].shape[1] \
        == moe.moe.n_experts // 2
    hyb = make_reduced(get_config("zamba2-1.2b"), tp=2)
    eng = _engine_tp2(hyb, trun, tg)
    assert eng.state.ssm.h.shape[2] == hyb.ssm.n_heads(hyb.d_model) // 2
    mla = make_reduced(get_config("deepseek-v2-lite-16b"), tp=2)
    attn = _engine_tp2(mla, trun, tg).params["blocks"]["attn"]
    m, hq = mla.mla, mla.padded_heads(2) // 2
    assert attn["wq"].shape[2] == hq * (m.qk_nope_dim + m.qk_rope_dim)
    assert attn["w_uk"].shape[2] == hq * m.qk_nope_dim
    assert attn["w_uv"].shape[2] == hq * m.v_dim
    assert attn["wo"].shape[1] == hq * m.v_dim
    assert attn["w_dkv"].shape[1] == mla.d_model // 2
    for name in ("seamless-m4t-large-v2", "internvl2-76b", "mamba2-370m"):
        cfg = make_reduced(get_config(name), tp=2)
        table = lm.lm_table(cfg, 2)
        assert ("xattn" in table["blocks"]) == cfg.encdec, name
        if cfg.encdec or cfg.frontend != "none":
            with pytest.raises(ValueError, match="continuous batching "
                               "covers decoder-only"):
                _engine_tp2(cfg, trun, tg)
    ssm = make_reduced(get_config("mamba2-370m"), tp=2)
    eng = _engine_tp2(ssm, trun, tg)
    assert eng.state.kv is None and eng._pages_in_use() == 0
    assert eng.state.ssm.h.shape[2] == ssm.ssm.n_heads(ssm.d_model) // 2
    dense = TModel(**_cfg_kw("gqa"))
    with pytest.raises(ValueError, match="cuda_graphs"):
        _engine_tp2(dense, trun, tg, cuda_graphs=True)
    with pytest.raises(ValueError, match="TPGroup"):
        _engine_tp2(dense, trun, None)
    with pytest.raises(ValueError, match="TPGroup"):
        _engine_tp2(dense, trun, TPGroup(0, 4, "gloo", cpu))
    sched = RequestScheduler(48, tp=2)
    with pytest.raises(ValueError, match=">= tp"):
        sched.submit(TReq(uid=0, prompt=np.zeros((1,), np.int32),
                          max_new_tokens=2))


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_init_tp_puts_each_rank_on_its_card(cards, monkeypatch):
    """``init_tp`` on ``device="cuda"`` (no index) puts rank r of 4 on
    card r modulo the cards and makes it the process's current card, and
    the launcher's ranks serve on their group's card; an indexed card or
    the CPU is kept.  The card count, ``set_device`` and the group's
    rendezvous are stand-ins: no card is needed."""
    from types import SimpleNamespace

    from repro_torch.launch import mesh, serve as launcher

    current, joined = [], []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: joined.append(kw))
    for rank in range(4):
        tg = mesh.init_tp(rank, 4, backend="nccl", device="cuda",
                          init_method="file:///unused")
        assert tg.device == torch.device("cuda", rank % cards)
        assert current[-1] == tg.device
        assert joined[-1]["rank"] == rank and joined[-1]["world_size"] == 4
        assert launcher._rank_device(SimpleNamespace(device="cuda"),
                                     tg) == tg.device
        tg = mesh.init_tp(rank, 4, backend="nccl", device="cuda:0",
                          init_method="file:///unused")
        assert tg.device == torch.device("cuda", 0)
    n_set = len(current)
    tg = mesh.init_tp(1, 4, backend="gloo", device="cpu",
                      init_method="file:///unused")
    assert tg.device == torch.device("cpu") and len(current) == n_set
    assert launcher._rank_device(SimpleNamespace(device="cpu"),
                                 None) == torch.device("cpu")
