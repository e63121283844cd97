"""Disaggregated serving at tp = 2: the port's ``DisaggEngine(group=)``
fleet on two spawned gloo ranks (``launch.mesh.spawn`` running
``launch.tp_jobs``, which imports no JAX) against the reference's
``DisaggEngine(tp=2)`` on two of conftest's fake devices, with the same
weights (the whole tree, cut to each rank's shard), on the reference
tests' dense, hybrid and MoE models and request mix
(``tests/test_disagg.py``: block 4, a shared prefix, a budget-1 request
that finishes on the prefill replica, more requests than slots):

* the fleet's streams, codec on and off, streaming on and off, equal the
  port's monolithic ``ServeEngine(tp=2)``'s, and the reference fleet's
  except that a request may part at a near-tie of the reference's own
  logits (``torch_tp_ref.part_at_near_ties``, ``ROADMAP.md`` section 3,
  item 2: the port's paged path teacher-forced within 5e-3 of the
  reference up to the parting position, the reference's top-2 margin
  there within 1e-2); both ranks alike; with codec and streaming on, the
  link counters and the decode replica's cross-import prefix hits equal
  the reference fleet's (the blobs carry every rank's pages in the
  reference's ``(tp, L, ...)`` layout);
* every handoff's closing blob, the port's and the reference's,
  round-trips byte for byte through both packages' serializers;
* across the packages, both ways: the reference's prefill replica's
  blobs imported by the port's tp = 2 decode replica, and the port's by
  the reference's, each serve the reference's streams;
* the socket path: ``launch.disagg_host --selftest --tp 2`` (a decode
  host of two ranks behind rank 0's socket, a driver of two ranks);
* ``launch.serve --disagg --tp 2 --dist-backend gloo`` in a
  subprocess."""

import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModel, MoEConfig as JMoE
from repro.configs.base import RunConfig as JRun, SSMConfig as JSSM
from repro.core.collectives import CodecConfig as JCodec
from repro.serve import Request as JRequest
from repro.serve import disagg as jdisagg
from repro.serve.transport import SequenceBlob as JBlob
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import MoEConfig as TMoE, RunConfig as TRun
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.launch import mesh, tp_jobs
from repro_torch.models import lm as tlm, params as tparams
from repro_torch.serve.transport import SequenceBlob as TBlob
from torch_tp_ref import part_at_near_ties, tree_np

torch.set_num_threads(2)

TP, MAXLEN, SLOTS, BLK = 2, 64, 2, 4
ROOT = Path(__file__).resolve().parents[1]
DENSE = dict(name="t2", family="dense", n_layers=2, d_model=64, n_heads=8,
             n_kv_heads=4, d_ff=128, vocab_size=500, head_dim=16)
HYBRID = dict(name="h", family="hybrid", n_layers=3, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=500, head_dim=16,
              parallel_hybrid=True, attn_layout="hymba_3global", window=16,
              sub_quadratic=True)
MOE = dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=4, d_ff=0, vocab_size=500, head_dim=16)
CASES = ("dense", "hybrid", "moe")
VARIANTS = [(c, s) for c in (True, False) for s in (True, False)]
BYTE_COUNTERS = ("n_transfers", "wire_bytes", "wire_bytes_nodedup",
                 "wire_raw_bytes", "dedup_page_refs", "pages_streamed",
                 "stream_chunk_bytes", "decode_prefix_hits")


def cfgs(case):
    if case == "hybrid":
        ssm = dict(d_state=16, headdim=8, chunk=16)
        return JModel(ssm=JSSM(**ssm), **HYBRID), \
            TModel(ssm=TSSM(**ssm), **HYBRID)
    if case == "moe":
        moe = dict(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                   capacity_factor=4.0)
        return JModel(moe=JMoE(**moe), **MOE), TModel(moe=TMoE(**moe), **MOE)
    return JModel(**DENSE), TModel(**DENSE)


def _runs(codec_on):
    jc = JCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=BLK)
    tc = TCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=BLK)
    return JRun(codec=jc), TRun(codec=tc)


def _mix():
    """``tests/test_disagg.py:_requests``: mixed lengths (odd ones whose
    tails replay at tp = 2), a shared prefix, a budget-1 request."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 500, (16,)).astype(np.int32)
    specs = [(a, 5), (rng.integers(0, 500, (9,)).astype(np.int32), 3),
             (a.copy(), 4), (rng.integers(0, 500, (12,)).astype(np.int32), 1),
             (a.copy(), 6)]
    return [dict(uid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]


FLEET = dict(n_prefill=1, n_decode=1, n_slots=SLOTS, max_len=MAXLEN,
             max_fuse_steps=1)
DECODE = dict(n_slots=SLOTS, max_len=MAXLEN, max_fuse_steps=1)


def _subprocess(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", module, "--device", "cpu",
                          *args], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    return out.returncode, out.stdout, out.stderr


def _ref_fleet(jcfg, params):
    """The reference's fleet at tp = 2, codec and streaming on: its
    streams, stats and each closing blob delivered (bytes, no dedup)."""
    jd = jdisagg.DisaggEngine(jcfg, _runs(True)[0], tp=TP, params=params,
                              streaming=True, **FLEET)
    blobs, dec = [], jd.decodes[0]
    deliver = dec.deliver

    def spy(h, transport, dst):
        blobs.append(dict(req=dict(uid=h.req.uid, prompt=h.req.prompt,
                                   max_new_tokens=h.req.max_new_tokens),
                          wire=h.blob.to_wire()[0]))
        return deliver(h, transport, dst)

    dec.deliver = spy
    res, st = jd.run([JRequest(**r) for r in _mix()])
    dec.deliver = deliver
    return jd, dict(streams=[(list(r.tokens), r.stop_reason) for r in res],
                    stats=st, blobs=blobs)


def _ref_decode(dec, blobs):
    """The reference's decode replica fed the port's closing blobs."""
    pending, out = list(blobs), {}
    while pending or not dec.idle():
        while pending and dec.free_slots():
            h = pending.pop(0)
            dec.import_handoff(jdisagg.Handoff(
                req=JRequest(**h["req"]), blob=JBlob.from_wire(h["wire"]),
                admit_t=0.0))
        for r in dec.step_window():
            out[r.uid] = (list(r.tokens), r.stop_reason)
    return out


@pytest.fixture(scope="module")
def served():
    """The port's fleets on one spawn of two ranks, the socket selftest
    and the launcher in subprocesses, all in threads while the reference
    serves its fleets; then the decode replicas fed the other package's
    blobs (the port's on a second, short spawn)."""
    ref, calls, params = {}, [], {}
    for seed, case in enumerate(CASES):
        _, tcfg = cfgs(case)
        gen = torch.Generator().manual_seed(seed + 1)
        params[case] = tree_np(tparams.init_params(tlm.lm_table(tcfg, TP),
                                                   gen))
        for i, (codec_on, streaming) in enumerate(VARIANTS):
            calls.append(("disagg", (tcfg, _runs(codec_on)[1], _mix(), dict(
                params=params[case], blobs=True, mono=i == 0,
                engine=dict(FLEET, streaming=streaming)))))
        calls.append(("serve", (tcfg, _runs(True)[1], _mix(), dict(
            params=params[case], forced=True, engine=DECODE))))
    with ThreadPoolExecutor(3) as pool:
        job = pool.submit(mesh.spawn, tp_jobs.batch, TP, backend="gloo",
                          args=(calls,))
        sock = pool.submit(_subprocess, "repro_torch.launch.disagg_host",
                           "--selftest", "--tp", "2", "--dist-backend",
                           "gloo")
        launch = pool.submit(_subprocess, "repro_torch.launch.serve",
                             "--disagg", "--tp", "2", "--dist-backend",
                             "gloo", "--streaming", "--requests", "3",
                             "--slots", "2", "--prompt-len", "16",
                             "--new-tokens", "3")
        fleets = {}
        for case in CASES:
            jcfg, _ = cfgs(case)
            fleets[case], ref[case] = _ref_fleet(
                jcfg, jax.tree_util.tree_map(jnp.asarray, params[case]))
            ref[case]["params"] = params[case]
        ranks = job.result()
        cross = [("decode_blobs", (cfgs(case)[1], _runs(True)[1],
                                   ref[case]["blobs"], dict(
                                       params=params[case], engine=DECODE)))
                 for case in CASES]
        cross = pool.submit(mesh.spawn, tp_jobs.batch, TP, backend="gloo",
                            args=(cross,))
        for case in CASES:
            ref[case]["cross"] = _ref_decode(
                fleets[case].decodes[0], ranks[0][_job(case, 0)]["blobs"])
        ref["port_cross"] = cross.result()
        ref["socket"], ref["launch"] = sock.result(), launch.result()
    return ref, ranks


def _job(case, k):
    """Job ``k`` of ``case``: the fleet variants, then the monolithic
    engine teacher-forced."""
    return CASES.index(case) * (len(VARIANTS) + 1) + k


@pytest.mark.parametrize("variant", range(len(VARIANTS)),
                         ids=["codec-stream", "codec", "raw-stream", "raw"])
@pytest.mark.parametrize("case", CASES)
def test_fleet_streams_equal_reference_and_monolithic(served, case,
                                                      variant):
    ref, ranks = served
    k = _job(case, variant)
    got = ranks[0][k]
    assert ranks[1][k]["streams"] == got["streams"]
    assert ranks[1][k]["stats"]["wire_bytes"] == got["stats"]["wire_bytes"]
    assert got["streams"] == ranks[0][_job(case, 0)]["mono"]
    forced = ranks[0][_job(case, len(VARIANTS))]["runs"][0]
    assert forced["streams"] == got["streams"]
    if variant == 0:           # the other variants' streams are the same
        jcfg, _ = cfgs(case)
        assert part_at_near_ties(
            jcfg, _runs(True)[0], TP, ref[case]["params"], _mix(),
            got["streams"], ref[case]["streams"], forced["forced"], None,
            BLK) <= 1
    st = got["stats"]
    assert st["n_transfers"] == len(_mix()) - 1      # budget 1: no transfer
    codec_on, streaming = VARIANTS[variant]
    assert (st["pages_streamed"] > 0) == streaming
    if codec_on:
        assert st["wire_bytes_nodedup"] < st["wire_raw_bytes"]
        assert 0 < st["link_reduction"] < 1
    if variant == 0:
        for f in BYTE_COUNTERS:
            assert st[f] == getattr(ref[case]["stats"], f), (case, f)


@pytest.mark.parametrize("case", CASES)
def test_blobs_round_trip_both_serializers(served, case):
    """Every closing blob of the port's fleets and of the reference's
    parses and re-serializes to the same bytes in both packages, and
    carries both ranks' shards."""
    ref, ranks = served
    blobs = [b["wire"] for v in range(len(VARIANTS))
             for b in ranks[0][_job(case, v)]["blobs"]]
    blobs += [b["wire"] for b in ref[case]["blobs"]]
    assert len(blobs) == (len(VARIANTS) + 1) * (len(_mix()) - 1)
    for data in blobs:
        tb = TBlob.from_wire(data)
        assert tb.tp == TP and tb.to_wire()[0] == data
        assert JBlob.from_wire(data).to_wire()[0] == data
    for v in range(len(VARIANTS)):
        assert [b["wire"] for b in ranks[1][_job(case, v)]["blobs"]] \
            == [b["wire"] for b in ranks[0][_job(case, v)]["blobs"]]


@pytest.mark.parametrize("case", CASES)
def test_handoffs_cross_the_packages(served, case):
    """The reference's prefill replica's blobs feed the port's tp = 2
    decode replica (both ranks importing their shards), and the port's
    feed the reference's decode replica: each serves the reference's
    streams."""
    ref, ranks = served
    want = {i: s for i, s in enumerate(ref[case]["streams"])}
    port = ref["port_cross"]
    k = CASES.index(case)
    for r in range(TP):
        got = port[r][k]
        assert got and all(got[u] == want[u] for u in got), (case, r)
    cross = ref[case]["cross"]
    assert cross and all(cross[u] == want[u] for u in cross), case
    assert set(cross) == set(port[0][k]) == set(want) - {3}


def test_socket_path_at_tp2(served):
    ref, _ = served
    code, out, err = ref["socket"]
    assert code == 0, (out + err)[-3000:]
    assert "params equal in both processes" in out
    assert "check ok: 6 streams identical" in out


def test_launcher_disagg_at_tp2(served):
    ref, _ = served
    code, out, err = ref["launch"]
    assert code == 0, err[-3000:]
    assert "disagg (tp 2)" in out and "sample continuations" in out
