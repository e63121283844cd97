"""The attention-free Mamba2 model at tp = 2: the port on two spawned gloo
ranks (``launch.mesh.spawn`` running ``launch.tp_jobs``, which imports no
JAX) against the reference at tp = 2 on two of conftest's fake devices
(NOT tp = 1: its tp = 2 function differs, ``ROADMAP.md`` section 3,
item 6), with the same weights (the whole tree, cut to each rank's
shard), on the reference tests' attention-free case
(``tests/test_decode.py``'s "ssm": 2 layers, d 64, d_state 16, headdim
8 -- 16 SSM heads, 8 a rank --, chunk 16; block 4) with its per-head
vectors seeded:

- the fixed loop: teacher-forced logits within 5e-3, greedy streams
  equal up to the near-tie rule (``ROADMAP.md`` section 3, item 2);
- ``ServeEngine(group=)``: no pool on any rank (``PagedState.kv`` None,
  every page count 0), admission with the tail replayed from
  ``(prompt_len // tp) * tp``, streams equal on both ranks and to the
  reference's ``ServeEngine(tp=2)`` up to near-ties of the reference's
  own logits (``torch_tp_ref.part_at_near_ties``), its admission and
  replay dispatches;
- packed weights: each rank's packed leaves the reference's
  ``pack_serving_params(..., tp=2)`` shards byte for byte, packed
  streams equal to raw;
- ``DisaggEngine(group=)``: streams equal to the monolithic engine's;
  every closing blob is the SSM section alone in the reference's ``(tp,
  L, ...)`` layout (no ``_FLAG_KV``), both ranks' bytes alike,
  re-serialized to the same bytes by both packages, each handoff's wire
  bytes and the link counters equal the reference fleet's; the
  reference's blobs imported by the port's tp = 2 decode replica serve
  the reference's streams;
- the launcher (``launch.serve --tp 2``: fixed, ``--continuous``,
  ``--disagg``) and ``launch.disagg_host --selftest --tp 2 --model
  mamba2-370m`` in subprocesses."""

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

from repro.configs.base import MeshConfig
from repro.configs.base import ModelConfig as JModel, RunConfig as JRun
from repro.configs.base import SSMConfig as JSSM
from repro.core import weights as jweights
from repro.core.collectives import CodecConfig as JCodec
from repro.models import lm as jlm, params as JPM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve import disagg as jdisagg
from repro.serve import transport as jtransport
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.launch import mesh, tp_jobs
from repro_torch.models import lm as tlm, params as tparams
from repro_torch.serve.transport import SequenceBlob as TBlob
from torch_port_util import bf16_np
from torch_tp_ref import (first_replay, part_at_near_ties, ref_fixed,
                          ref_forced, tree_np)

torch.set_num_threads(2)

KW = dict(name="s", family="ssm", n_layers=2, d_model=64, n_heads=0,
          n_kv_heads=0, d_ff=0, vocab_size=500, sub_quadratic=True)
SSM_KW = dict(d_state=16, headdim=8, chunk=16)
JCFG, TCFG = JModel(ssm=JSSM(**SSM_KW), **KW), TModel(ssm=TSSM(**SSM_KW),
                                                      **KW)
TP, MAXLEN, SLOTS, BLK = 2, 48, 2, 4
ROOT = Path(__file__).resolve().parents[1]
JRUN, TRUN = JRun(codec=JCodec(cache_block=BLK)), TRun(
    codec=TCodec(cache_block=BLK))
ENGINE = dict(n_slots=SLOTS, max_len=MAXLEN, max_fuse_steps=1)
LINK = ("n_transfers", "wire_bytes", "wire_bytes_nodedup", "wire_raw_bytes",
        "dedup_page_refs", "pages_streamed")


def _tree():
    """Seeded weights of the tp = 2 table (numpy), the zeros/ones SSM
    vectors seeded so that they count."""
    gen = torch.Generator().manual_seed(1)
    params = tree_np(tparams.init_params(tlm.lm_table(TCFG, TP), gen))
    rng = np.random.default_rng(5)
    s = params["blocks"]["ssm"]
    s["dt_bias"] = bf16_np(rng, s["dt_bias"].shape, 0.5)
    s["a_log"] = bf16_np(rng, s["a_log"].shape, 0.5)
    for name in ("d_skip", "gate_norm"):
        s[name] = (1 + bf16_np(rng, s[name].shape, 0.2).astype(
            np.float32)).astype(ml_dtypes.bfloat16)
    return params


def _mix():
    """Odd prompt lengths (a one-token tail replays at tp = 2), more
    requests than slots, a budget-1 request (it finishes on a fleet's
    prefill replica)."""
    rng = np.random.default_rng(0)
    specs = [(8, 5), (13, 6), (5, 9), (12, 1), (13, 4)]
    return [dict(uid=i, prompt=rng.integers(0, 500, (s,)).astype(np.int32),
                 max_new_tokens=n) for i, (s, n) in enumerate(specs)]


def _streams(res):
    return [(list(r.tokens), r.stop_reason) for r in res]


def _subprocess(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", module, "--device", "cpu",
                          "--tp", "2", "--dist-backend", "gloo", *args],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    return out.returncode, out.stdout, out.stderr


LAUNCH = {"fixed": ("repro_torch.launch.serve", "--arch", "mamba2-370m",
                    "--batch", "2", "--prompt-len", "12", "--new-tokens",
                    "3"),
          "continuous": ("repro_torch.launch.serve", "--arch",
                         "mamba2-370m", "--continuous", "--requests", "3",
                         "--slots", "2", "--prompt-len", "16",
                         "--new-tokens", "3"),
          "disagg": ("repro_torch.launch.serve", "--arch", "mamba2-370m",
                     "--disagg", "--requests", "3", "--slots", "2",
                     "--prompt-len", "16", "--new-tokens", "3"),
          "host": ("repro_torch.launch.disagg_host", "--selftest",
                   "--model", "mamba2-370m")}


def _ref_fleet(params):
    """The reference's fleet at tp = 2: streams, link stats and each
    closing blob delivered (bytes, no dedup)."""
    jd = jdisagg.DisaggEngine(JCFG, JRUN, tp=TP, params=params,
                              n_prefill=1, n_decode=1, **ENGINE)
    blobs, dec = [], jd.decodes[0]
    deliver = dec.deliver

    def spy(h, transport, dst):
        blobs.append(dict(req=dict(uid=h.req.uid, prompt=h.req.prompt,
                                   max_new_tokens=h.req.max_new_tokens),
                          wire=h.blob.to_wire()[0]))
        return deliver(h, transport, dst)

    dec.deliver = spy
    res, st = jd.run([JRequest(**r) for r in _mix()])
    return dict(streams=_streams(res), stats=st, blobs=blobs)


@pytest.fixture(scope="module")
def served():
    """The reference's engine, fixed loop, packing and fleet, beside one
    spawn of two port ranks (the engine raw and packed, the fixed loop
    teacher-forced with the reference's stream, the fleet and the
    monolithic engine, then a decode replica fed the reference's blobs)
    and the launchers' subprocesses."""
    params = _tree()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = {}
    s, n = 10, 8
    max_len = s + n + BLK * TP
    prompts = np.random.default_rng(3).integers(0, 500, (3, s)) \
        .astype(np.int32)
    ref["fixed"] = ref_fixed(JCFG, JRUN, TP, params, prompts, n, max_len)
    ref["fleet"] = _ref_fleet(jp)
    calls = [
        ("serve", (TCFG, TRUN, _mix(), dict(params=params, forced=True,
                                            engine=ENGINE))),
        ("serve", (TCFG, TRUN, _mix(), dict(
            params=params, packed_leaves=True,
            engine=dict(ENGINE, compress_weights=True)))),
        ("fixed", (TCFG, TRUN, prompts, n, max_len, dict(
            params=params, forced=ref["fixed"][0][:, :n]))),
        ("disagg", (TCFG, TRUN, _mix(), dict(
            params=params, blobs=True, mono=True,
            engine=dict(ENGINE, n_prefill=1, n_decode=1)))),
        ("decode_blobs", (TCFG, TRUN, ref["fleet"]["blobs"], dict(
            params=params, engine=ENGINE)))]
    with ThreadPoolExecutor(len(LAUNCH) + 1) as pool:
        job = pool.submit(mesh.spawn, tp_jobs.batch, TP, backend="gloo",
                          args=(calls,))
        launch = {k: pool.submit(_subprocess, *v) for k, v in LAUNCH.items()}
        je = JEngine(JCFG, JRUN, tp=TP, params=jp, **ENGINE)
        res, st = je.run([JRequest(**r) for r in _mix()])
        ref["serve"] = dict(streams=_streams(res), stats=st)
        k = first_replay(_mix(), TP)
        ref["replay"] = ref_forced(JCFG, JRUN, TP, params, _mix()[k]["prompt"],
                                   ref["serve"]["streams"][k][0], BLK)
        table = jlm.lm_table(JCFG, MeshConfig(data=1, model=TP, pod=1), JRUN)
        packed, specs = jweights.pack_serving_params(
            jp, JPM.param_pspecs(table), tp=TP)
        ref["packed"] = dict(params=jax.tree_util.tree_map(np.asarray,
                                                           packed),
                             specs=specs)
        ref["params"] = params
        ranks = job.result()
        ref["launch"] = {k: f.result() for k, f in launch.items()}
    return ref, ranks


def test_fixed_loop_matches_reference(served):
    """Teacher-forced logits within 5e-3 of the reference's tp = 2; the
    greedy streams alike on both ranks and equal to the reference's up to
    its first top-2 margin within 1e-2."""
    ref, ranks = served
    want, logits = ref["fixed"]
    got = ranks[0][2]
    assert (ranks[1][2]["tokens"] == got["tokens"]).all()
    np.testing.assert_allclose(got["logits"][..., :500], logits[..., :500],
                               atol=5e-3)
    top2 = np.sort(logits[..., :500], -1)[..., -2:]
    near_tie = ((top2[..., 1] - top2[..., 0]) <= 1e-2).T     # (B, n + 1)
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got["tokens"][b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0])
    assert got["wire"]["kinds"]["all_gather"]["overflows"] == 0


def test_serve_engine_streams_and_no_pages(served):
    """``ServeEngine(group=)``: both ranks' streams alike and the
    reference's up to near-ties; no page on either rank, as in the
    reference (``peak_pages`` 0); the reference's admission and replay
    dispatch counts (the one-token tails replay)."""
    ref, ranks = served
    got = ranks[0][0]["runs"][0]
    js = ref["serve"]["stats"]
    for r in range(TP):
        run = ranks[r][0]["runs"][0]
        assert run["streams"] == got["streams"], r
        assert ranks[r][0]["pages_in_use"] == 0
        st = run["stats"]
        assert st["peak_pages"] == js.peak_pages == 0
        assert st["peak_cache_bytes"] == js.peak_cache_bytes == 0
        assert st["n_admit_dispatches"] == js.n_admit_dispatches
        assert st["n_replay_dispatches"] == js.n_replay_dispatches > 0
    assert part_at_near_ties(JCFG, JRUN, TP, ref["params"], _mix(),
                             got["streams"], ref["serve"]["streams"],
                             got["forced"], ref["replay"], BLK) <= 1
    w = got["wire"]
    assert 0 < w["wire_bytes"] < w["raw_bytes"] and w["overflows"] == 0


def test_packed_leaves_and_streams(served):
    """Each rank's packed leaves are the reference's packed whole leaves
    cut along their PartitionSpec's model dim, byte for byte (``w_zx``'s
    and ``lm_head``'s column shards, ``w_out``'s row shard); the packed
    engine serves the raw streams."""
    ref, ranks = served
    assert ranks[0][1]["runs"][0]["streams"] \
        == ranks[0][0]["runs"][0]["streams"]
    params, specs = ref["packed"]["params"], ref["packed"]["specs"]
    paths = set(ranks[0][1]["packed"])
    assert paths == {"blocks/ssm/w_zx", "blocks/ssm/w_out", "lm_head"}
    for path in paths:
        node, spec = params, specs
        for key in path.split("/"):
            node, spec = node[key], spec[key]
        for f in ("signman", "planes", "dict_syms"):
            whole = np.asarray(getattr(node, f))
            sp = tuple(getattr(spec, f))
            sp = sp + (None,) * (whole.ndim - len(sp))
            for r in range(TP):
                part = np.split(whole, TP, axis=sp.index("model"))[r] \
                    if "model" in sp else whole
                got = ranks[r][1]["packed"][path]
                assert int(node.k) == got["k"]
                assert (got[f].view(np.uint8) == part.view(np.uint8)).all(), \
                    (path, f, r)


def test_fleet_blobs_and_streams(served):
    """``DisaggEngine(group=)``: the monolithic streams on both ranks;
    each closing blob carries every rank's SSM state (``(tp, L, ...)``,
    8 heads a rank) and no KV, both ranks' bytes alike, and re-serializes
    to the same bytes in both packages; each handoff's wire bytes and the
    link counters equal the reference fleet's."""
    ref, ranks = served
    got = ranks[0][3]
    assert got["streams"] == got["mono"] == ranks[0][0]["runs"][0]["streams"]
    assert [b["wire"] for b in ranks[1][3]["blobs"]] \
        == [b["wire"] for b in got["blobs"]]
    want = ref["fleet"]
    assert len(got["blobs"]) == len(want["blobs"]) == len(_mix()) - 1
    sizes = {}
    for b in got["blobs"] + want["blobs"]:
        data = b["wire"]
        tb = TBlob.from_wire(data)
        assert tb.tp == TP and tb.kv is None and tb.n_cols == 0
        assert tb.ssm[0].shape[:3] == (TP, 2, 8)
        assert tb.to_wire()[0] == data
        assert jtransport.SequenceBlob.from_wire(data).to_wire()[0] == data
        flags = jtransport._HDR.unpack_from(data)[2]
        assert not flags & jtransport._FLAG_KV and flags & \
            jtransport._FLAG_SSM
        sizes.setdefault(b["req"]["uid"], set()).add(len(data))
    assert all(len(v) == 1 for v in sizes.values()), sizes
    for f in LINK:
        assert got["stats"][f] == getattr(want["stats"], f), f


def test_reference_blobs_decode_on_the_port(served):
    """The reference's prefill replica's blobs imported by the port's tp
    = 2 decode replica (each rank its shard of the SSM state) serve the
    reference fleet's streams."""
    ref, ranks = served
    want = dict(enumerate(ref["fleet"]["streams"]))
    for r in range(TP):
        got = ranks[r][4]
        assert set(got) == set(want) - {3}
        assert all(got[u] == want[u] for u in got), r


@pytest.mark.parametrize("mode", list(LAUNCH))
def test_launchers_at_tp2(served, mode):
    ref, _ = served
    code, out, err = ref["launch"][mode]
    assert code == 0, (out + err)[-3000:]
    if mode == "host":
        assert "check ok: 6 streams identical" in out
    else:
        assert "sample continuations" in out
    if mode == "continuous":
        assert "continuous (tp 2)" in out and "paged cache peak 0 pages" \
            in out
