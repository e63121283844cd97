"""The training slice's host modules against the reference on the same
numpy-seeded inputs: the LEXI-H container (``core/{huffman,bitstream}``:
codebooks equal, bytes identical, exact round trips), the synthetic data
pipeline (batches equal, data-rank slices reassembling the global batch),
fault tolerance (the reference's ``TestFault`` cases), the optimizer
(``adamw_update``, ``global_norm``, ``lr_at`` within rtol 1e-6) and
checkpoints (leaf files and manifest entries byte-identical, each package
restoring the other's, the reference's atomicity and corruption cases).
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig as JMeshConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.core import bitstream as jbs
from repro.core import collectives as jcl
from repro.core import huffman as jhuff
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs.base import RunConfig
from repro_torch.core import bitstream, huffman, tree
from repro_torch.data import pipeline as data
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models.params import PDef
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as TS
from torch_port_util import bits, to_np, to_torch

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# LEXI-H
# ---------------------------------------------------------------------------

def _bf16_cases():
    rng = np.random.default_rng(0)
    normal = rng.normal(0, 0.02, 4096)
    spread = rng.normal(0, 1, 5000) * np.exp2(rng.integers(-60, 61, 5000))
    return {"normal-4096": normal, "escapes": spread,
            "constant": np.full(3000, 1.5), "ragged": rng.normal(0, 1, 777),
            "zeros-and-subnormal": np.concatenate(
                [np.zeros(100), np.full(5, 1e-40), rng.normal(0, 1, 100)])}


@pytest.mark.parametrize("name", list(_bf16_cases()))
def test_lexi_h_bf16_bytes(name):
    u16 = _bf16_cases()[name].astype(ml_dtypes.bfloat16).view(np.uint16)
    blob = bitstream.compress_bf16(u16)
    assert blob == jbs.compress_bf16(u16)
    assert np.array_equal(bitstream.decompress_bf16(blob), u16)


@pytest.mark.parametrize("name", list(_bf16_cases()))
def test_lexi_h_f32_bytes(name):
    x = _bf16_cases()[name].astype(np.float32)
    blob = bitstream.compress_f32(x)
    assert blob == jbs.compress_f32(x)
    assert np.array_equal(bitstream.decompress_f32(blob).view(np.uint32),
                          x.view(np.uint32))


def test_codebooks_equal():
    rng = np.random.default_rng(1)
    for hist in (rng.integers(0, 1000, 256), np.eye(256)[7] * 50,
                 np.exp(-0.1 * (np.arange(256) - 120.0) ** 2) * 1e6):
        a, b = huffman.build_codebook(hist), jhuff.build_codebook(hist)
        for f in ("symbols", "lengths", "enc_code", "enc_len",
                  "in_alphabet"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert bitstream.serialize_codebook(a) == \
            jbs.serialize_codebook(b)
    assert huffman.length_limited_lengths([5, 1, 1, 3], max_len=2) == \
        jhuff.length_limited_lengths([5, 1, 1, 3], max_len=2)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (1, 17), (5, 3), (123, 999)])
def test_batches_equal_the_reference(seed, step):
    mine = data.SyntheticLM(vocab_size=1009, global_batch=4, seq_len=32,
                            seed=seed).batch_at(step)
    ref = jdata.SyntheticLM(vocab_size=1009, global_batch=4, seq_len=32,
                            seed=seed).batch_at(step)
    for k in ("tokens", "labels"):
        assert mine[k].dtype == torch.int32
        assert np.array_equal(mine[k].numpy(), np.asarray(ref[k]))
    parts = [data.shard_batch(mine, r, 2) for r in range(2)]
    for k in ("tokens", "labels"):
        assert np.array_equal(torch.cat([p[k] for p in parts]).numpy(),
                              np.asarray(ref[k]))


def test_for_config_refuses_multimodal():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig("t", 16, 2, "train")
    assert data.for_config(get_config("qwen1.5-1.8b"), shape).vocab_size \
        == 151936
    for arch in ("internvl2-76b", "seamless-m4t-large-v2"):
        with pytest.raises(NotImplementedError, match="queue 1, item 4"):
            data.for_config(get_config(arch), shape)


# ---------------------------------------------------------------------------
# fault tolerance (the reference's TestFault, on the port's module)
# ---------------------------------------------------------------------------

def test_straggler_detection():
    mon = fault.StragglerMonitor(tolerance=2.0)
    for i in range(20):
        mon.record(i, 0.1)
    assert mon.record(20, 0.5)
    assert 20 in mon.straggler_steps


def test_watchdog():
    wd = fault.Watchdog(deadline_s=0.0)
    wd.arm()
    time.sleep(0.01)
    assert wd.expired
    wd.disarm()
    assert not wd.expired


def test_run_with_restarts():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise fault.SimulatedFailure("boom")
        return {"ok": True}

    out = fault.run_with_restarts(flaky, max_restarts=5, backoff_s=0,
                                  log=lambda *_: None)
    assert out["ok"] and out["restarts"] == 2


def test_restart_exhaustion():
    def always():
        raise fault.SimulatedFailure("dead")

    with pytest.raises(fault.SimulatedFailure):
        fault.run_with_restarts(always, max_restarts=1, backoff_s=0,
                                log=lambda *_: None)


# ---------------------------------------------------------------------------
# optimizer (mesh 1 x 1)
# ---------------------------------------------------------------------------

SHAPES = {"w": (16, 24), "stack": (2, 8, 32), "norm": (24,)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    mk = lambda s, std: rng.normal(0, std, s)
    params = {k: mk(s, 0.02).astype(ml_dtypes.bfloat16)
              for k, s in SHAPES.items()}
    grads = {k: mk(s, 0.5).astype(ml_dtypes.bfloat16)
             for k, s in SHAPES.items()}
    master = {k: np.asarray(v, np.float32) for k, v in params.items()}
    m = {k: mk(s, 0.1).astype(np.float32) for k, s in SHAPES.items()}
    v = {k: np.abs(mk(s, 0.1)).astype(np.float32) for k, s in SHAPES.items()}
    return params, grads, master, m, v


@pytest.mark.parametrize("step,clip", [(0, 1.0), (7, 1.0), (149, 1e3)])
def test_adamw_matches_the_reference(mesh11, step, clip):
    params, grads, master, m, v = _trees(step)
    run_kw = dict(grad_clip=clip, warmup_steps=10)
    jrun, run = JRunConfig(**run_kw), RunConfig(**run_kw)
    specs = {k: P(*([None] * len(s))) for k, s in SHAPES.items()}
    jstate = jopt.OptState(jnp.asarray(step, jnp.int32), master, m, v)

    def body(p, g, o):
        return jopt.adamw_update(jrun, p, g, o, specs, ("data", "model"),
                                 total_steps=200)
    ospec = jopt.OptState(P(), specs, specs, specs)
    mspec = {"grad_norm": P(), "lr": P(), "clip_scale": P()}
    want = jax.jit(jcl.shmap(body, mesh11, (specs, specs, ospec),
                             (specs, ospec, mspec)))(params, grads, jstate)

    t = lambda tr: {k: to_torch(a) for k, a in tr.items()}
    table = {k: PDef(s) for k, s in SHAPES.items()}
    state = opt.OptState(torch.tensor(step, dtype=torch.int32), t(master),
                         t(m), t(v))
    got = opt.adamw_update(run, t(params), t(grads), state, table,
                           Mesh(1, 1, None), total_steps=200)
    for a, b in zip(tree.leaves(got[0]), jax.tree.leaves(want[0])):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(to_np(a).astype(np.float32),
                                   np.asarray(b, np.float32), rtol=1e-6,
                                   atol=0)
    assert int(got[1].step) == int(want[1].step) == step + 1
    # master, m, v: rtol 1e-6 of each leaf's largest magnitude (XLA
    # contracts b * m + (1 - b) * g into a fused multiply-add, so where the
    # two products cancel the results differ below one ulp of the products)
    for a, b in zip(tree.leaves(got[1][1:]), jax.tree.leaves(want[1][1:])):
        b = np.asarray(b)
        np.testing.assert_allclose(to_np(a), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max())
    for k in ("grad_norm", "lr", "clip_scale"):
        np.testing.assert_allclose(float(got[2][k]), float(want[2][k]),
                                   rtol=1e-6)


def test_lr_schedule_matches_the_reference():
    run = RunConfig(warmup_steps=7)
    jrun = JRunConfig(warmup_steps=7)
    for s in (0, 1, 6, 7, 8, 50, 99, 100, 140):
        np.testing.assert_allclose(
            float(opt.lr_at(run, torch.tensor(s, dtype=torch.int32), 100)),
            float(jopt.lr_at(jrun, jnp.asarray(s, jnp.int32), 100)),
            rtol=1e-6)


def test_global_norm_counts_replicated_once():
    """The reference's replication case at one rank: a 'data'-sharded leaf
    is psum'd over a one-rank axis, a replicated one counted once."""
    g = {"rep": torch.ones(8, 4), "shard": torch.ones(8, 4)}
    table = {"rep": PDef((8, 4)), "shard": PDef((8, 4), spec=("data", None),
                                                fsdp_dim=0)}
    assert abs(float(opt.global_norm(g, table, Mesh(1, 1, None)))
               - np.sqrt(64)) < 1e-6


# ---------------------------------------------------------------------------
# checkpoints (the reference tests' model)
# ---------------------------------------------------------------------------

CFG_KW = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=500, head_dim=16)


@pytest.fixture(scope="module")
def states():
    """A reference ``TrainState`` of the reference tests' model (numpy-
    seeded params N(0, 0.02) in bf16, ones and zeros as the table says;
    a fresh optimizer state at step 3) and the same state carried into
    the port."""
    from repro.models import params as jPM
    cfg = JModelConfig(**CFG_KW)
    table = jlm.lm_table(cfg, JMeshConfig(1, 1, 1), JRunConfig())
    rng = np.random.default_rng(3)

    def one(d):
        a = (np.full(d.shape, 1.0 if d.init == "ones" else 0.0)
             if d.init in ("ones", "zeros") else rng.normal(0, 0.02, d.shape))
        return jnp.asarray(a.astype(ml_dtypes.bfloat16))
    params = jPM.tmap(one, table)
    st = jts.TrainState(params, jopt.init_opt_state(params)._replace(
        step=jnp.asarray(3, jnp.int32)))
    return st, TS.from_jax_state(st)


def _entries(d):
    with open(os.path.join(d, "MANIFEST.json")) as fh:
        return json.load(fh)


def test_checkpoint_files_match_the_reference(states, tmp_path):
    jst, st = states
    assert len(tree.leaves(st)) == len(jax.tree.leaves(jst))
    dj = jckpt.save(str(tmp_path / "ref"), 5, jst)
    dp = ckpt.save(str(tmp_path / "port"), 5, st)
    mj, mp = _entries(dj), _entries(dp)
    assert mj["leaves"] == mp["leaves"]
    assert (mp["step"], mp["n_leaves"], mp["extra"]) == \
        (mj["step"], mj["n_leaves"], mj["extra"])
    codecs = {e["codec"] for e in mp["leaves"]}
    assert codecs == {"lexi-h", "lexi-f32", "raw"}
    for e in mp["leaves"]:
        with open(os.path.join(dj, e["file"]), "rb") as a, \
                open(os.path.join(dp, e["file"]), "rb") as b:
            assert a.read() == b.read(), e["file"]
    assert ckpt.stored_size(str(tmp_path / "port"), 5) == \
        jckpt.stored_size(str(tmp_path / "ref"), 5)

    # each package restores the other's checkpoint to the same arrays
    got = ckpt.restore(str(tmp_path / "ref"), st)
    back = jckpt.restore(str(tmp_path / "port"), jst)
    for a, b, c in zip(tree.leaves(got), jax.tree.leaves(back),
                       tree.leaves(st)):
        assert np.array_equal(bits(a), bits(c))
        assert np.array_equal(bits(np.asarray(b)), bits(c))


def test_checkpoint_roundtrip_latest_and_atomic(states, tmp_path):
    _, st = states
    d = str(tmp_path)
    ckpt.save(d, 5, st)
    ckpt.save(d, 10, st.params)
    assert ckpt.latest_step(d) == 10
    back = ckpt.restore(d, st, step=5)
    for a, b in zip(tree.leaves(back), tree.leaves(st)):
        assert a.dtype == b.dtype and np.array_equal(bits(a), bits(b))
    # bf16 params alone compress (the reference's threshold)
    sz = ckpt.stored_size(d, 10)
    assert sz["stored_bytes"] < sz["raw_bytes"] * 0.75
    # a .tmp_ directory is never advertised via LATEST
    assert not any(f.startswith(".tmp") for f in os.listdir(d))
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_corruption_detected(states, tmp_path):
    _, st = states
    d = ckpt.save(str(tmp_path), 2, st.params)
    victim = [f for f in sorted(os.listdir(d)) if f.startswith("leaf")][0]
    with open(os.path.join(d, victim), "r+b") as fh:
        fh.seek(10)
        fh.write(b"\xde\xad")
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), st.params, step=2)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"x": st.params["embed"]}, step=2)


def test_train_scope_raises():
    from repro_torch.configs import get_config, make_reduced
    mesh = Mesh(1, 1, None)
    run = RunConfig()
    for arch in ("granite-moe-1b-a400m", "zamba2-1.2b", "mamba2-370m",
                 "deepseek-v2-lite-16b", "seamless-m4t-large-v2",
                 "internvl2-76b"):
        with pytest.raises(NotImplementedError, match="queue 1, item 4"):
            TS.check_train(get_config(arch), mesh, run)
    cfg = make_reduced(get_config("qwen1.5-1.8b"))
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        TS.check_train(cfg, Mesh(1, 2, None, pod=2), run)
    with pytest.raises(ValueError, match="tp_strategy"):
        TS.check_train(cfg, Mesh(1, 2, None),
                       RunConfig(tp_strategy="pipeline"))
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        make_mesh(MeshConfig(data=1, model=2, pod=2))
