"""The port's training path against the reference on numpy-seeded inputs.

On spawned gloo ranks at world 2 (one spawn, ``launch.tp_jobs``): the
differentiable collectives (``lexi_all_gather``, ``lexi_psum``,
``lexi_all_to_all``, ``lexi_ppermute``) -- forward and the gradient of a
seeded scalar loss bit for bit equal to the reference's ``jax.grad``
under ``shmap`` (a sum of two bf16 values is rounded once at world 2) --
``sync_gradients`` (bits and wire bytes), and three train steps of the
reduced qwen1.5-1.8b at mesh 2x1 from the reference's initial state.
The same steps at mesh 1x1 run in this process.  Losses, grad norms and
step 0's synced gradients are held to the reference's own 2x1 steps
(compiled once), within the tolerances below; port 2x1 to port 1x1 at
step 0.  Reduced gemma2-9b's loss and gradients (tied and scaled
embeddings, softcaps) at 1x1.  ``core.weights``' compressed store and its FSDP gather equal
the reference's bit for bit.  Then ``launch.train.main`` at 2x1
recovers from an injected failure, and the loss falls over 16 steps at
1x1.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs import make_reduced as jmake_reduced
from repro.configs.base import MeshConfig as JMeshConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.core import collectives as jcl
from repro.core import fixed as jfixed
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.models import params as jPM
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import get_config, make_reduced
from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
from repro_torch.core import collectives as tcl
from repro_torch.launch import mesh, tp_jobs
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from torch_port_util import bf16_np

torch.set_num_threads(2)

ARCH = "qwen1.5-1.8b"
SEQ, BATCH, STEPS = 32, 4, 3
# tolerances against the reference, about 4x the largest gaps measured
# over the 3 steps at 1x1 and 2x1 and gemma2's step 0 (PERF.md): loss
# 2.7e-5, grad norm 2.7e-4, gradients 1.2e-2 of a leaf's largest (a few
# bf16 units), port 2x1 against port 1x1 6.9e-8
LOSS_RTOL = 1e-4
GNORM_RTOL = 1e-3
GRAD_TOL = 2e-2            # times the leaf's largest reference gradient
SELF_RTOL = 1e-6           # port 2x1 against port 1x1, step 0's loss
RUN_KW = dict(warmup_steps=1)


def _pair(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return ("bf16", a.view(np.uint16))
    return a


def _grad_cases():
    """(op, per-rank inputs (2, ...), per-rank cotangent weights (2, ...)
    of the output's shape, keywords, codec)."""
    rng = np.random.default_rng(24)
    x = lambda shape, spread=6: bf16_np(rng, (2,) + shape, 1.0, spread)
    off = jcl.CodecConfig.off()
    return [
        ("all_gather", x((4, 6, 32)), x((8, 6, 32)), dict(gather_axis=0),
         None),
        ("all_gather", x((3, 5, 64)), x((3, 10, 64)), dict(gather_axis=1),
         None),
        ("all_gather", x((4, 64), 60), x((4, 128)), dict(gather_axis=1),
         None),
        ("all_gather", x((4, 6, 32)), x((8, 6, 32)), dict(gather_axis=0),
         off),
        ("psum", x((4, 6, 32)), x((4, 6, 32)), {}, None),
        ("psum", x((3, 5, 7)), x((3, 5, 7)), {}, None),
        ("all_to_all", x((4, 6, 32)), x((4, 6, 32)),
         dict(split_axis=0, concat_axis=0), None),
        ("all_to_all", x((3, 4, 8)), x((3, 8, 4)),
         dict(split_axis=1, concat_axis=2), None),
        ("ppermute", x((4, 6, 32)), x((4, 6, 32)),
         dict(perm=[(0, 1), (1, 0)]), None),
        ("ppermute", x((5, 32)), x((5, 32)), dict(perm=[(0, 1)]), None),
    ]


def _port_codec(codec):
    return tcl.CodecConfig() if codec is None else tcl.CodecConfig.off()


def _ref_grads(cases):
    """The reference's forward and input gradient of each case under one
    shmap on 2 devices, per rank stacked."""
    mesh_ = jax.make_mesh((2,), ("model",))

    def one(op, x, w, kw, codec):
        codec = codec or jcl.CodecConfig()

        def f(x):
            if op == "all_gather":
                return jcl.lexi_all_gather(x, "model", codec, **kw)
            if op == "psum":
                return jcl.lexi_psum(x, "model", codec)
            if op == "all_to_all":
                return jcl.lexi_all_to_all(x, "model", codec, **kw)
            return jcl.lexi_ppermute(x, "model", tuple(kw["perm"]), codec)
        y = f(x)
        g = jax.grad(lambda x: jnp.sum(f(x).astype(jnp.float32)
                                       * w.astype(jnp.float32)))(x)
        return y[None], g[None]

    def body(*xws):
        out = []
        for (op, _, _, kw, codec), x, w in zip(cases, xws[::2], xws[1::2]):
            out += one(op, x[0], w[0], kw, codec)
        return tuple(out)

    spec = tuple(P("model") for _ in range(2 * len(cases)))
    args = [jnp.asarray(a) for c in cases for a in (c[1], c[2])]
    got = jax.jit(jcl.shmap(body, mesh_, spec, spec))(*args)
    return [np.asarray(a) for a in got]


SYNC_TREE = {"a": ((6, 10), "bf16"), "b": ((7,), "f32"),
             "c": ((3, 5, 4), "bf16")}


def _sync_trees():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        t = {}
        for k, (shape, dt) in SYNC_TREE.items():
            v = rng.normal(0, 1, shape) * np.exp2(rng.integers(-3, 4, shape))
            t[k] = v.astype(ml_dtypes.bfloat16 if dt == "bf16"
                            else np.float32)
        out.append(t)
    return out


def _ref_sync(trees, codec):
    """The reference's ``sync_gradients`` per rank, and each rank's
    reduce-scattered part of the fused buffer (what its wire carries)."""
    mesh_ = jax.make_mesh((2,), ("model",))
    keys = sorted(SYNC_TREE)

    def body(*xs):
        t = {k: x[0] for k, x in zip(keys, xs)}
        out = jcl.sync_gradients(t, ("model",), codec)
        flat = jnp.concatenate([t[k].reshape(-1).astype(jnp.bfloat16)
                                for k in keys])
        flat = jnp.pad(flat, (0, (-flat.size) % 2))
        part = jax.lax.psum_scatter(flat, "model", scatter_dimension=0,
                                    tiled=True)
        return tuple(out[k][None] for k in keys) + (part[None],)

    spec = tuple(P("model") for _ in keys)
    got = jax.jit(jcl.shmap(body, mesh_, spec, spec + (P("model"),)))(
        *(jnp.asarray(np.stack([t[k] for t in trees])) for k in keys))
    return {k: np.asarray(v) for k, v in zip(keys, got)}, np.asarray(got[-1])


FSDP_TREE = {"w": ((64, 96), "bf16"), "f": ((80, 64), "f32"),
             "small": ((8, 4), "bf16"), "i": ((16,), "i32")}


def _fsdp_trees():
    rng = np.random.default_rng(11)
    dts = {"bf16": ml_dtypes.bfloat16, "f32": np.float32, "i32": np.int32}
    return [{k: (rng.normal(0, 0.02, shape) * (1000 if dt == "i32" else 1))
             .astype(dts[dt]) for k, (shape, dt) in FSDP_TREE.items()}
            for _ in range(2)]


def _ref_fsdp(trees):
    """The reference's ``fsdp_gather_params`` of each rank's compressed
    shards, per rank stacked; rank 0's ``stored_bytes`` and the
    decompressed store."""
    from repro.core import weights as jw
    mesh_ = jax.make_mesh((2,), ("model",))
    keys = sorted(FSDP_TREE)
    codec = jcl.CodecConfig()

    def body(*xs):
        t = {k: x[0] for k, x in zip(keys, xs)}
        out = jw.fsdp_gather_params(jw.compress_params(t, codec), "model",
                                    codec)
        return tuple(out[k][None] for k in keys)

    spec = tuple(P("model") for _ in keys)
    got = jax.jit(jcl.shmap(body, mesh_, spec, spec))(
        *(jnp.asarray(np.stack([t[k] for t in trees])) for k in keys))
    cp0 = jw.compress_params({k: jnp.asarray(v) for k, v in
                              trees[0].items()}, codec)
    return ({k: np.asarray(v) for k, v in zip(keys, got)},
            jw.stored_bytes(cp0), jw.param_bytes(trees[0]),
            {k: np.asarray(v) for k, v in jw.decompress_params(cp0).items()})


def _ref_wire(x, codec=jcl.CodecConfig()):
    ct = jfixed.compress(jnp.asarray(x), k=codec.k,
                         esc_capacity=codec.esc_capacity(x.size))
    return np.concatenate([np.asarray(f).reshape(-1).view(np.uint8) for f in
                           (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos,
                            ct.esc_raw, ct.n_escapes)])


def _ref_steps(jstate, batches):
    """The reference's train step at mesh 2x1 (its own FSDP sharding,
    compressed gathers and gradient sync), compiled once: each step's
    metrics and step 0's synced gradients (whole leaves)."""
    cfg = jmake_reduced(jget_config(ARCH))
    run = JRunConfig(**RUN_KW)
    mesh_cfg = JMeshConfig(2, 1, 1)
    table = jlm.lm_table(cfg, mesh_cfg, run)
    dims = jlm.lm_fsdp_dims(table)
    pspecs = jPM.param_pspecs(table)
    axes = ("data", "model")

    def body(state, batch):
        def loss_fn(p):
            return jlm.train_loss(cfg, run, p, batch, 1, ("data",),
                                  dims=dims)
        local, grads = jax.value_and_grad(loss_fn)(state.params)
        loss = jax.lax.psum(local, axes)
        grads = jopt.sync_grads(grads, pspecs, axes, run)
        p, o, m = jopt.adamw_update(run, state.params, grads, state.opt,
                                    pspecs, axes, STEPS)
        return jts.TrainState(p, o), dict(m, loss=loss), grads

    mspecs = {k: P() for k in ("loss", "grad_norm", "lr", "clip_scale")}
    sspecs = jts.state_pspecs(table)
    f = jax.jit(jcl.shmap(body, jax.make_mesh((2, 1), axes),
                          (sspecs, jts.batch_pspecs(cfg, mesh_cfg)),
                          (sspecs, mspecs, pspecs)))
    metrics, grads0 = [], None
    for b in batches:
        jstate, m, g = f(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if grads0 is None:
            grads0 = [np.asarray(x, np.float32) for x in jax.tree.leaves(g)]
    return metrics, grads0


def _init_state(table):
    """The reference's fresh ``TrainState`` for ``table`` from numpy-seeded
    params (normal leaves N(0, 0.02) rounded to bf16, ones, zeros)."""
    rng = np.random.default_rng(0)

    def one(d):
        if d.init in ("ones", "zeros"):
            a = np.full(d.shape, 1.0 if d.init == "ones" else 0.0)
        else:
            a = rng.normal(0, 0.02, d.shape)
        return jnp.asarray(a.astype(ml_dtypes.bfloat16))
    params = jPM.tmap(one, table)
    return jts.TrainState(params, jopt.init_opt_state(params))


@pytest.fixture(scope="module")
def runs():
    """One spawn of two ranks for every world-2 job, the reference's
    counterparts and the port's 1x1 steps, side by side."""
    cfg = make_reduced(get_config(ARCH))
    jcfg = jmake_reduced(jget_config(ARCH))
    table = jlm.lm_table(jcfg, JMeshConfig(2, 1, 1), JRunConfig(**RUN_KW))
    jstate = _init_state(table)
    leaves = [_pair(a) for a in jax.tree.leaves(jstate)]
    data = jdata.SyntheticLM(vocab_size=jcfg.vocab_size, global_batch=BATCH,
                             seq_len=SEQ, seed=0)
    batches = [{k: np.array(v) for k, v in data.batch_at(i).items()}
               for i in range(STEPS)]
    gcases = _grad_cases()
    jobs = [dict(op=op, xs=[_pair(a) for a in xs], ws=[_pair(a) for a in ws],
                 kw=kw, codec=_port_codec(codec))
            for op, xs, ws, kw, codec in gcases]
    trees = _sync_trees()
    ptrees = [{k: _pair(v) for k, v in t.items()} for t in trees]
    fsdp_trees = _fsdp_trees()
    ftrees = [{k: _pair(v) for k, v in t.items()} for t in fsdp_trees]
    run = RunConfig(**RUN_KW)
    work = [
        lambda: mesh.spawn(tp_jobs.batch, 2, backend="gloo", args=([
            ("lexi_grads", (jobs,)),
            ("sync_gradients", (ptrees, tcl.CodecConfig())),
            ("sync_gradients", (ptrees, tcl.CodecConfig.off())),
            ("fsdp_gather", (ftrees, tcl.CodecConfig())),
            ("train_steps", (cfg, run, MeshConfig(2, 1, 1), leaves,
                             batches))],)),
        lambda: _ref_steps(jstate, batches),
        lambda: dict(ref_grads=_ref_grads(gcases), ref_fsdp=_ref_fsdp(
            fsdp_trees), ref_sync={c: _ref_sync(trees, codec) for c, codec in
                                   (("on", jcl.CodecConfig()),
                                    ("off", jcl.CodecConfig.off()))},
            gemma2=_gemma2(batches[0]))]
    # the spawned ranks and the reference's compiles run side by side
    with concurrent.futures.ThreadPoolExecutor(len(work)) as pool:
        futures = [pool.submit(fn) for fn in work]
        solo = tp_jobs.train_steps(None, cfg, run, MeshConfig(1, 1, 1),
                                   leaves, batches)
        got, ref_steps, misc = (f.result() for f in futures)
    return dict(misc, got=got, solo=solo, gcases=gcases, trees=trees,
                ref_steps=ref_steps)


def _gemma2(batch):
    """Reduced gemma2-9b (tied embeddings, scaled embeddings, final and
    attention softcaps, alternating local windows) at mesh 1x1: the
    reference's loss and gradients, and the port's on the same numpy-
    seeded params and batch."""
    from repro_torch.core import tree
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.train_step import from_jax_state
    jcfg = jmake_reduced(jget_config("gemma2-9b"))
    run = JRunConfig(**RUN_KW)
    table = jlm.lm_table(jcfg, JMeshConfig(1, 1, 1), run)
    jstate = _init_state(table)
    dims, specs = jlm.lm_fsdp_dims(table), jPM.param_pspecs(table)

    def body(p, b):
        return jax.value_and_grad(lambda p: jlm.train_loss(
            jcfg, run, p, b, 1, ("data",), dims=dims))(p)
    bspec = {"tokens": P(), "labels": P()}
    loss, grads = jax.jit(jcl.shmap(
        body, jax.make_mesh((1, 1), ("data", "model")), (specs, bspec),
        (P(), specs)))(jstate.params, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    cfg = make_reduced(get_config("gemma2-9b"))
    prun = RunConfig(**RUN_KW)
    ptable = lm.lm_table(cfg, run=prun)
    params = tree.map_(lambda x: x.requires_grad_(),
                       from_jax_state(jstate).params)
    mine = lm.train_loss(cfg, prun, params, {
        k: torch.from_numpy(v) for k, v in batch.items()}, Mesh(1, 1, None),
        lm.lm_fsdp_dims(ptable))
    pgrads = torch.autograd.grad(mine, tree.leaves(params))
    return dict(loss=(float(mine.detach()), float(loss)), grads=[
        (g.float().numpy(), np.asarray(w, np.float32))
        for g, w in zip(pgrads, jax.tree.leaves(grads))])


def _u16(pair):
    return pair[1] if isinstance(pair, tuple) else np.asarray(pair)


@pytest.mark.parametrize("i", range(10))
def test_lexi_grads_bit_exact(runs, i):
    op, xs, ws, kw, codec = runs["gcases"][i]
    want_y, want_g = runs["ref_grads"][2 * i], runs["ref_grads"][2 * i + 1]
    for r in range(2):
        got = runs["got"][r][0][i]
        assert np.array_equal(_u16(got["y"]), want_y[r].view(np.uint16)), \
            (op, kw, r, "forward")
        assert np.array_equal(_u16(got["g"]), want_g[r].view(np.uint16)), \
            (op, kw, r, "gradient")


@pytest.mark.parametrize("codec", ["on", "off"])
def test_sync_gradients_bit_exact(runs, codec):
    want, parts = runs["ref_sync"][codec]
    job = 1 if codec == "on" else 2
    for r in range(2):
        got = runs["got"][r][job]
        for k, (_, dt) in SYNC_TREE.items():
            g = got["out"][k]
            w = want[k][r]
            if dt == "bf16":
                assert np.array_equal(_u16(g), w.view(np.uint16)), (k, r)
            else:
                assert g.dtype == np.float32
                assert np.array_equal(g.view(np.uint32),
                                      w.view(np.uint32)), (k, r)
        if codec == "on":
            assert len(got["wire"]) == 1
            assert np.array_equal(got["wire"][0].reshape(-1),
                                  _ref_wire(parts[r])), r
        else:
            assert got["wire"] == []


def test_fsdp_gather_params_matches_the_reference(runs):
    want, stored, raw, back = runs["ref_fsdp"]
    for r in range(2):
        got = runs["got"][r][3]
        for k, (_, dt) in FSDP_TREE.items():
            g, w = got["gathered"][k], want[k][r]
            assert np.array_equal(np.asarray(_u16(g)).view(np.uint8),
                                  np.ascontiguousarray(w).view(np.uint8)), k
    got = runs["got"][0][3]
    assert (got["stored"], got["raw"]) == (stored, raw)
    assert stored < raw
    for k in FSDP_TREE:
        assert np.array_equal(np.asarray(_u16(got["back"][k])).view(np.uint8),
                              np.ascontiguousarray(back[k]).view(np.uint8))


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_train_steps_match_the_reference(runs):
    ref_metrics, ref_grads = runs["ref_steps"]
    r0, r1 = (runs["got"][r][4] for r in range(2))
    assert r0["metrics"] == r1["metrics"]          # the ranks agree
    for name, res in (("2x1", r0), ("1x1", runs["solo"])):
        for s, (got, want) in enumerate(zip(res["metrics"], ref_metrics)):
            assert np.isfinite(got["loss"])
            assert _rel(got["loss"], want["loss"]) < LOSS_RTOL, (name, s)
            assert _rel(got["grad_norm"], want["grad_norm"]) < GNORM_RTOL, \
                (name, s)
            assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        for g, w in zip(res["grads"], ref_grads):
            g = _u16(g).view(ml_dtypes.bfloat16).astype(np.float32) \
                if isinstance(g, tuple) else g
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), name
    assert _rel(r0["metrics"][0]["loss"], runs["solo"]["metrics"][0]["loss"]) \
        < SELF_RTOL
    # the FSDP gathers and the gradient sync went compressed, losslessly
    for w in r0["wire"]:
        assert w["calls"] > 0 and w["overflows"] == 0
        assert w["wire_bytes"] < w["raw_bytes"]
    assert all(w["calls"] == 0 for w in runs["solo"]["wire"])


def test_gemma2_loss_and_grads_match_the_reference(runs):
    got, want = runs["gemma2"]["loss"]
    assert _rel(got, want) < LOSS_RTOL
    for g, w in runs["gemma2"]["grads"]:
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


def test_cli_recovers_from_a_failure(tmp_path, capfd):
    d = str(tmp_path / "ckpt")
    assert launch_train.main([
        "--arch", ARCH, "--reduced", "--mesh", "2x1", "--device", "cpu",
        "--steps", "3", "--batch", "4", "--seq", "16", "--ckpt-dir", d,
        "--ckpt-every", "2", "--simulate-failure", "2"]) == 0
    out = capfd.readouterr().out
    assert "injected failure at step 2" in out
    assert "resumed from step 2" in out and "restarts=1" in out
    with open(os.path.join(d, "LATEST")) as fh:
        assert fh.read() == "step_00000003"


def test_loss_falls_at_1x1():
    cfg = make_reduced(get_config(ARCH))
    out = launch_train.train_loop(
        cfg, ShapeConfig("t", SEQ, BATCH, "train"), MeshConfig(1, 1, 1),
        RunConfig(**RUN_KW), steps=16,
        ckpt_dir=None, ckpt_every=0, resume=False, log=lambda *_: None,
        device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.3
