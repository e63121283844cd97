"""The fixed loop's two stub-input families against the reference at
tp = 1 (device="cpu", weights bridged from the reference):

- the encoder-decoder of the reference's ``tests/test_decode.py``
  ("encdec": 2 + 2 layers, d 64, 4/4 heads, hd 16; block 4): the
  encoder's memory, the prefill and teacher-forced decode logits (within
  5e-3, as ``ROADMAP.md`` section 3, item 2 has it), the cross-attention
  store (``DecodeState.xkv``) byte for byte the reference's from the same
  memory, decode over the fixed memory against a teacher-forced prefill
  (the reference's ``test_encdec_decode``), the greedy streams;
- a tiny vision-stub VLM: ``front_embeds`` replace the first
  ``n_frontend_tokens`` positions (logits within 5e-3 of the
  reference's; tokens there change nothing);
- ``ServeEngine`` and ``DisaggEngine`` refuse both families with the
  reference's error, and the launcher serves reduced seamless and
  internvl2 in fixed mode only (``ROADMAP.md`` section 3, item 7: the
  VLM is no longer served as a text model)."""

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
from repro.models import layers as jlayers, lm as jlm, params as jparams
from repro.serve import ServeEngine as JEngine, engine as jengine
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.models import blocks as tblocks, cache as tcache
from repro_torch.models import lm as tlm
from repro_torch.models.params import from_jax_params
from repro_torch.serve import engine as tengine
from repro_torch.serve.disagg import DisaggEngine
from repro_torch.serve.scheduler import ServeEngine
from torch_port_util import bits, to_torch

torch.set_num_threads(2)

ENC = dict(name="e", family="encdec", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=4, d_ff=128, vocab_size=500, head_dim=16, encdec=True,
           frontend="audio_stub")
VLM = dict(name="v", family="vlm", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=500, head_dim=16,
           frontend="vision_stub", n_frontend_tokens=8)
BLK, MAXLEN = 4, 64
B, S, NDEC = 3, 30, 8           # 30 tokens: the stores' tails in the ring
REFUSAL = ("continuous batching covers decoder-only, text-frontend "
           "architectures")
MESH = jax.make_mesh((1, 1), ("data", "model"))
JRUN = JRun(codec=JCodec(cache_block=BLK))
TRUN = TRun(codec=TCodec(cache_block=BLK))


def shm_jit(f, n):
    return jax.jit(jcl.shmap(f, MESH, tuple(P() for _ in range(n)), P()))


def _model(kw):
    jcfg, tcfg = JModel(**kw), TModel(**kw)
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=1, pod=1), JRUN)
    jp = jparams.init_params(table, jax.random.key(1))
    return jcfg, tcfg, jlm.lm_fsdp_dims(table), jp, \
        from_jax_params(jax.device_get(jp))


@pytest.fixture(scope="module")
def encdec():
    """The enc-dec model, its inputs (tokens for S + NDEC positions, the
    encoder's S + NDEC frames) and the reference's prefill of the first S
    tokens, then NDEC teacher-forced decode steps (logits of each)."""
    jcfg, tcfg, dims, jp, tp_ = _model(ENC)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 500, (B, S + NDEC)).astype(np.int32)
    enc = jnp.asarray(rng.normal(0, 1, (B, S + NDEC, 64)), jnp.bfloat16)
    prefill = shm_jit(lambda p, t, e: jengine.prefill(
        jcfg, JRUN, p, dims, t, MAXLEN, 1, enc_embeds=e), 3)
    step = shm_jit(lambda p, st, tok: jengine.decode_step(
        jcfg, JRUN, p, dims, st, tok, 1), 3)
    lg0, st0 = prefill(jp, jnp.asarray(toks[:, :S]), enc)
    xkv = jax.device_get(st0.xkv)
    lgs, lg, st = [np.asarray(lg0)], lg0, st0
    for i in range(NDEC):
        lg, st = step(jp, st, jnp.asarray(toks[:, S + i:S + i + 1]))
        lgs.append(np.asarray(lg))
    # the reference's own greedy loop from the same prefill
    greedy, lg, st = [], lg0, st0
    for i in range(NDEC + 1):
        greedy.append(np.asarray(lg)[:, 0, :500])
        if i < NDEC:
            lg, st = step(jp, st, jnp.asarray(
                greedy[-1].argmax(-1).astype(np.int32)[:, None]))
    return dict(jcfg=jcfg, tcfg=tcfg, dims=dims, jp=jp, params=tp_,
                toks=toks, enc=enc, tenc=to_torch(np.asarray(enc)),
                xkv=xkv, logits=np.stack(lgs, 1)[..., :500],
                greedy_logits=np.stack(greedy, 1))


def _ref_memory(m):
    """The reference's encoder output for the fixture's frames: its
    encoder trunk, ``enc_norm`` and the tp = 1 gather (a codec round
    trip), as its ``lm_forward`` runs them."""
    jcfg, sm = m["jcfg"], m["enc"].shape[1]

    def mem(p, e):
        spec = jlayers.AttnSpec(causal=False, softcap=jcfg.attn_softcap)
        ex, _, _ = jlm._scan_blocks(jcfg, JRUN, p["enc_blocks"],
                                    m["dims"]["enc_blocks"],
                                    e.astype(jnp.bfloat16),
                                    jnp.arange(sm, dtype=jnp.int32), spec, 1)
        ex = jlayers.rms_norm(ex, p["enc_norm"], jcfg.norm_eps)
        return jcl.lexi_all_gather(ex, "model", JRUN.codec, gather_axis=1)

    return np.asarray(shm_jit(mem, 2)(m["jp"], m["enc"]))


def test_tables_and_encoder_memory(encdec):
    """The enc-dec table has the reference's leaves and shapes; the
    port's encoder memory is within bf16 rounding of the reference's."""
    jt = jlm.lm_table(encdec["jcfg"], MeshConfig(data=1, model=1, pod=1),
                      JRUN)
    jleaves = {jax.tree_util.keystr(k): v.shape for k, v in
               jax.tree_util.tree_flatten_with_path(
                   jt, is_leaf=jparams.is_pdef)[0]}

    def flat(t, path=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(flat(v, f"{path}['{k}']"))
            return out
        return {path: tuple(t.shape)}

    assert flat(tlm.lm_table(encdec["tcfg"])) == jleaves
    assert {"enc_blocks", "enc_norm"} <= set(encdec["params"])
    assert {"ln_x", "xattn"} <= set(encdec["params"]["blocks"])
    assert "xattn" not in encdec["params"]["enc_blocks"]
    got = tlm.encode(encdec["tcfg"], TRUN, encdec["params"],
                     encdec["tenc"]).float().numpy()
    np.testing.assert_allclose(got, _ref_memory(encdec).astype(np.float32),
                               rtol=1e-2, atol=1e-2)


def test_prefill_and_decode_logits(encdec):
    """Prefill of S tokens over the S + NDEC frames, then NDEC decode
    steps fed the given tokens: every step's logits within 5e-3 of the
    reference's; the cross store is static (xlen rows) and the decode
    steps leave it untouched."""
    m = encdec
    lt, st = tengine.prefill(m["tcfg"], TRUN, m["params"],
                             torch.as_tensor(m["toks"][:, :S]), MAXLEN,
                             enc_embeds=m["tenc"])
    assert st.xlen == S + NDEC and len(st.xkv) == 2
    before = [bits(x.signman).copy() for x in st.xkv]
    got = [lt.numpy()]
    for i in range(NDEC):
        got.append(tengine.decode_step(
            m["tcfg"], TRUN, m["params"], st,
            torch.as_tensor(m["toks"][:, S + i:S + i + 1])).numpy())
    got = np.stack(got, 1)[..., :500]
    np.testing.assert_allclose(got, m["logits"], atol=5e-3)
    assert all((bits(x.signman) == b).all() for x, b in zip(st.xkv, before))


def test_cross_store_byte_identical(encdec):
    """From the reference's memory, every decoder layer's cross-attention
    store -- the encoder's K/V of S + NDEC frames, full blocks compressed,
    the tail in the ring -- equals the reference's ``xkv`` byte for byte
    (the port's own memory differs from the reference's by bf16 rounding,
    as deeper layers' K/V do: ``ROADMAP.md`` section 3, item 3)."""
    m = encdec
    mem = to_torch(_ref_memory(m))
    sm = mem.shape[1]
    pos = torch.arange(sm, dtype=torch.int32)
    for i in range(m["tcfg"].n_layers):
        xa = tlm.layer_params(m["params"], i)["xattn"]
        _, xkv = tblocks.cross_attn_forward(m["tcfg"], TRUN, xa, mem[:, :1],
                                            mem, pos[:1], pos, True)
        store = tcache.empty_kv(m["tcfg"], TRUN, B, MAXLEN, group=B)
        tcache.fill_from_prefill(m["tcfg"], TRUN, store,
                                 tengine.kv_payload(*xkv))
        assert sm % BLK and store.nblk == MAXLEN // BLK + 2
        for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
                  "ring"):
            want = np.asarray(getattr(m["xkv"], f))[i]
            got = getattr(store, f)
            got = got if f == "ring" else got[0]
            assert (bits(got) == bits(want)).all(), (i, f)


def test_decode_over_fixed_memory_matches_prefill(encdec):
    """Decode with a FIXED encoder memory against a prefill of the whole
    sequence over the same memory (the reference's
    ``test_encdec_decode``, its 0.05), and the greedy streams of
    ``generate`` against the reference's logits: equal up to the first
    step whose reference top-2 margin is within 1e-2."""
    m = encdec
    toks = torch.as_tensor(m["toks"])
    lt, st = tengine.prefill(m["tcfg"], TRUN, m["params"], toks[:, :S],
                             MAXLEN, enc_embeds=m["tenc"])
    for i in range(NDEC):
        lt = tengine.decode_step(m["tcfg"], TRUN, m["params"], st,
                                 toks[:, S + i:S + i + 1])
    lf, _ = tengine.prefill(m["tcfg"], TRUN, m["params"], toks, MAXLEN,
                            enc_embeds=m["tenc"])
    assert float((lt - lf)[..., :500].abs().max()) < 0.05
    want_lg = m["greedy_logits"]                     # (B, NDEC + 1, V)
    want = want_lg.argmax(-1)
    got = tengine.generate(m["tcfg"], TRUN, m["params"], toks[:, :S], NDEC,
                           MAXLEN, enc_embeds=m["tenc"]).numpy()
    top2 = np.sort(want_lg, -1)[..., -2:]
    near_tie = top2[..., 1] - top2[..., 0] <= 1e-2
    for b in range(B):
        diff = np.flatnonzero(got[b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0], got[b], want[b])


def test_vlm_front_embeds(capsys):
    """The vision stub: the reference's prefill logits within 5e-3 with
    front embeds; the token ids at the first n_frontend_tokens positions
    change nothing (their embeddings are replaced), one past them does."""
    jcfg, tcfg, dims, jp, tp_ = _model(VLM)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 500, (2, 16)).astype(np.int32)
    fe = jnp.asarray(rng.normal(0, 1, (2, 8, 64)), jnp.bfloat16)
    lg, _ = shm_jit(lambda p, t, f: jengine.prefill(
        jcfg, JRUN, p, dims, t, 32, 1, front_embeds=f), 3)(
            jp, jnp.asarray(toks), fe)
    tfe = to_torch(np.asarray(fe))

    def port(t):
        return tengine.prefill(tcfg, TRUN, tp_, torch.as_tensor(t), 32,
                               front_embeds=tfe)[0].numpy()[..., :500]

    got = port(toks)
    np.testing.assert_allclose(got, np.asarray(lg)[..., :500], atol=5e-3)
    inside, past = toks.copy(), toks.copy()
    inside[:, :8] = (inside[:, :8] + 1) % 500
    past[:, 8] = (past[:, 8] + 1) % 500
    assert np.array_equal(port(inside), got)
    assert not np.array_equal(port(past), got)
    text = tengine.prefill(tcfg, TRUN, tp_, torch.as_tensor(toks), 32)[0]
    assert not np.array_equal(text.numpy()[..., :500], got)


@pytest.mark.parametrize("kw", [ENC, VLM], ids=["encdec", "vlm"])
def test_continuous_engines_refuse(kw):
    """``ServeEngine`` (and the ``DisaggEngine`` built on it) refuse
    enc-dec and non-text-frontend configs with the reference's error."""
    with pytest.raises(ValueError, match=REFUSAL):
        JEngine(JModel(**kw), JRUN, tp=1, n_slots=2, max_len=32)
    with pytest.raises(ValueError, match=REFUSAL):
        ServeEngine(TModel(**kw), TRUN, n_slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match=REFUSAL):
        DisaggEngine(TModel(**kw), TRUN, n_slots=2, max_len=32,
                     device="cpu")


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-76b"])
def test_launcher_fixed_only(arch, capsys):
    """``launch.serve`` serves reduced seamless and internvl2 in fixed
    mode, with the reference launcher's stub inputs drawn after the
    prompts (the probe of ``ROADMAP.md`` section 3, item 7: internvl2's
    first 8 positions take the front embeds), and refuses them with
    ``--continuous`` and ``--disagg``."""
    from repro_torch.configs import get_config, make_reduced
    from repro_torch.launch import serve
    from repro_torch.models import params as PM

    argv = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--new-tokens", "4"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    printed = out.split("sample continuations: ")[-1].strip()
    cfg = make_reduced(get_config(arch))
    run = TRun(codec=TCodec(cache_block=32))
    params = PM.init_params(tlm.lm_table(cfg),
                            torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)),
                              dtype=torch.int32)
    extras = serve.stub_inputs(cfg, rng, 2, 16, "cpu")
    assert set(extras) == ({"enc_embeds"} if cfg.encdec
                           else {"front_embeds"})
    want = tengine.generate(cfg, run, params, prompts, 4, 16 + 4 + 32,
                            **extras)
    assert printed == str(want[:2, :12].tolist())
    if not cfg.encdec:          # the VLM is not served as a text model
        text = tengine.generate(cfg, run, params, prompts, 4, 16 + 4 + 32)
        assert not torch.equal(text, want)
    for mode in ("--continuous", "--disagg"):
        with pytest.raises(ValueError, match=REFUSAL):
            serve.main(argv + [mode])
