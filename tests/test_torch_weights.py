"""The port's packed serving weight plane against the JAX package, on the
CPU: the plain ``decompress_matmul`` and ``lexi_unpack`` against the
reference's Pallas kernels (interpret mode) and oracles, ``ops.unpack``
against ``fixed.decompress``, ``pack_serving_params`` byte-identical to the
reference's, greedy streams served from packed weights equal to the
reference's packed and the port's raw-weight streams, and the weight
backend rules.  The CUDA kernels are held against these plain versions in
test_torch_gpu.py."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig
from repro.configs.base import ModelConfig as JModel
from repro.configs.base import RunConfig as JRun
from repro.core import fixed as jfixed
from repro.core import weights as jW
from repro.core.collectives import CodecConfig as JCodec
from repro.kernels import ref as jref
from repro.kernels.decompress_matmul import decompress_matmul as j_dm
from repro.kernels.lexi_unpack import lexi_unpack as j_unpack
from repro.launch.disagg_host import tiny_bench_config
from repro.models import lm as jlm
from repro.models import params as jPM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import fixed as tfixed
from repro_torch.core import weights as tW
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models.params import from_jax_params, to_device
from repro_torch.serve.scheduler import Request as TRequest
from repro_torch.serve.scheduler import ServeEngine as TEngine
from repro_torch.serve.scheduler import format_stats
from torch_port_util import bf16_np, bits, to_torch

torch.set_num_threads(2)


def _weight_np(rng, shape, n_exp):
    """bf16 values with exactly ``n_exp`` distinct exponents (random sign
    and mantissa): escape-free at k iff n_exp <= 2^k - 1."""
    e = rng.integers(0, n_exp, shape) - 6
    m = 1 + rng.integers(0, 128, shape) / 128
    s = rng.choice([-1.0, 1.0], shape)
    return (s * m * np.exp2(e)).astype(ml_dtypes.bfloat16)


def _product_tol(x, w):
    """Elementwise bound for an f32 product of bf16 operands summed in
    another order: 1e-5 * (|x| @ |W|) + 1e-6 (the products are exact in
    f32; K <= 301 terms of rounding at 6e-8 each stay far below 1e-5)."""
    ax = np.abs(np.asarray(x, np.float64))
    aw = np.abs(np.asarray(w, np.float64))
    return 1e-5 * (ax @ aw) + 1e-6


# ---------------------------------------------------------------------------
# the kernels' plain versions against the reference kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 5, 6])
def test_decompress_matmul_plain_matches_reference(k):
    """Odd M and K, N = 32 * odd; the reference kernel pads every dim to
    its blocks (bk 128, bn 256), the port's plain version does not."""
    rng = np.random.default_rng(k)
    m, kk, n = 37, 301, 32 * 9
    w = _weight_np(rng, (kk, n), (1 << k) - 1)
    x = bf16_np(rng, (m, kk))
    jsm, jpl, jd, jne = jref.compress_weight_2d(jnp.asarray(w), k=k)
    sm, pl, d, ne = tref.compress_weight_2d(to_torch(w), k=k)
    assert int(jne) == int(ne) == 0
    for a, b in ((jsm, sm), (jpl, pl), (jd, d)):
        assert np.asarray(a).shape == tuple(b.shape)
        assert (bits(np.asarray(a)) == bits(b)).all()
    kern = ops.compress_weight(to_torch(w), k=k)     # CPU: plain versions
    for a, b in zip((sm, pl, d, ne), kern):
        assert torch.equal(a, b)
    got = ops.matmul_compressed(to_torch(x), sm, pl, d, k=k).numpy()
    want_kernel = np.asarray(j_dm(jnp.asarray(x), jsm, jpl, jd, k=k,
                                  interpret=True))
    want_ref = np.asarray(jref.decompress_matmul_ref(jnp.asarray(x), jsm,
                                                     jpl, jd, k))
    tol = _product_tol(x, w)
    assert got.shape == (m, n)
    assert (np.abs(got - want_kernel) <= tol).all()
    assert (np.abs(got - want_ref) <= tol).all()
    # the plain version is the exact decode then the f32 product
    exact = np.asarray(x, np.float32) @ np.asarray(w, np.float32)
    assert (np.abs(got - exact) <= tol).all()


@pytest.mark.parametrize("k", [4, 5, 6])
def test_unpack_plain_matches_lexi_unpack(k):
    """Arbitrary bits (every code, every signman byte): bit for bit.  The
    reference kernel shares one dictionary over the rows; the port takes
    one per row, here the same one repeated."""
    rng = np.random.default_rng(10 + k)
    g, b = 3, 32 * 37
    sm = rng.integers(0, 256, (g, b)).astype(np.uint8)
    planes = rng.integers(0, 1 << 32, (g, k, b // 32),
                          dtype=np.uint64).astype(np.uint32)
    d = rng.integers(0, 256, (1 << k,)).astype(np.uint8)
    want = j_unpack(jnp.asarray(sm), jnp.asarray(planes), jnp.asarray(d),
                    k=k, interpret=True)
    got = ops.unpack_rows(torch.as_tensor(sm),
                          torch.as_tensor(planes.view(np.int32)),
                          torch.as_tensor(np.tile(d, (g, 1))), k)
    assert (bits(np.asarray(want)) == bits(got)).all()
    assert (bits(np.asarray(jref.unpack_ref(jnp.asarray(sm),
                                            jnp.asarray(planes),
                                            jnp.asarray(d), k)))
            == bits(got)).all()


@pytest.mark.parametrize("spread,cap", [(0, None), (9, None), (40, 8)],
                         ids=["no-escapes", "escapes", "overflow"])
def test_ops_unpack_matches_fixed_decompress(spread, cap):
    """The kernel-backed decompress (escape-free unpack + side-channel
    patch) against the reference's ``fixed.decompress``, one tensor and a
    stack of pages, with escapes and with escape overflow."""
    rng = np.random.default_rng(spread)
    x = bf16_np(rng, (4, 16, 24), spread=spread)
    for k in (4, 5):
        jct = jfixed.compress(jnp.asarray(x[0]), k=k, esc_capacity=cap)
        want = bits(np.asarray(jfixed.decompress(jct)))
        ct = tfixed.compress(to_torch(x[0]), k=k, esc_capacity=cap)
        assert (bits(ops.unpack(ct)) == want).all()
        many = tfixed.compress_many(to_torch(x), k=k, esc_capacity=cap)
        assert (bits(ops.unpack(many)) == bits(tfixed.decompress(many))).all()
        if spread == 40:
            assert int(ct.n_escapes) > ct.esc_pos.shape[0]


# ---------------------------------------------------------------------------
# pack_serving_params against the reference's
# ---------------------------------------------------------------------------

def _assert_same_store(jtree, ttree, path=""):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for key in jtree:
            _assert_same_store(jtree[key], ttree[key], f"{path}/{key}")
        return
    if isinstance(jtree, jW.PackedWeight):
        assert isinstance(ttree, tW.PackedWeight), path
        assert ttree.k == jtree.k and ttree.shape == jtree.shape, path
        for f in ("signman", "planes", "dict_syms"):
            a, b = np.asarray(getattr(jtree, f)), getattr(ttree, f)
            assert a.shape == tuple(b.shape), (path, f)
            assert (bits(a) == bits(b)).all(), (path, f)
    else:
        assert not isinstance(ttree, tW.PackedWeight), path
        assert (bits(np.asarray(jtree)) == bits(ttree)).all(), path


def _shape_set_tree():
    """The shapes of the reference's tests/test_weight_plane.py:_tree()
    (with its one unstacked 2-D matrix at the top level, where the port's
    tree keeps unstacked leaves), plus a leaf whose exponents escape even
    at k = 6 (raw in both)."""
    rng = np.random.default_rng(0)
    mk = lambda shape: bf16_np(rng, shape, 0.05)
    return {"embed": mk((512, 64)),           # gather consumer -> raw
            "wq": mk((64, 64)),               # 4096 elements -> packs
            "wide": bf16_np(rng, (64, 96), spread=60),   # escapes -> raw
            "blocks": {"stack": mk((3, 64, 64)),  # stacked leaf -> packs
                       "scale": np.ones((64,), ml_dtypes.bfloat16),  # 1-D
                       "small": mk((8, 8))}}      # < MIN_COMPRESS_SIZE


def test_pack_serving_params_shape_set_matches_reference():
    tree = _shape_set_tree()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jpk, _ = jW.pack_serving_params(
        jtree, jax.tree_util.tree_map(lambda _: P(), tree), backend="jax",
        tp=1)
    tpk = tW.pack_serving_params(from_jax_params(tree))
    _assert_same_store(jpk, tpk)
    assert isinstance(tpk["wq"], tW.PackedWeight)
    assert isinstance(tpk["blocks"]["stack"], tW.PackedWeight)
    assert not isinstance(tpk["wide"], tW.PackedWeight)
    assert tW.weight_plane_bytes(tpk) == jW.weight_plane_bytes(jpk)
    # lossless, stacked slices included; idempotent on packed leaves
    for leaf in (tpk["wq"], tpk["blocks"]["stack"]):
        back = tW.unpack_weight(leaf)
        assert back.shape == leaf.shape
    assert (bits(tW.unpack_weight(tpk["blocks"]["stack"]))
            == bits(tree["blocks"]["stack"])).all()
    assert (bits(tlayers.raw_weight(tpk["wq"])) == bits(tree["wq"])).all()
    again = tW.pack_serving_params(tpk)
    _assert_same_store(jpk, again)
    # the bridge turns the reference's packed leaves into the port's
    _assert_same_store(jpk, from_jax_params(jpk))


def test_stacked_norm_scale_stays_raw():
    """A stacked norm scale (L, d) with L * d >= 4096 is 1-D per layer:
    the port keeps it raw.  The reference packs it as one (L, d) matrix
    (ROADMAP.md queue 3), and its serving scan then fails on it."""
    ones = np.ones((64, 64), ml_dtypes.bfloat16)
    tree = {"blocks": {"ln1": ones}}
    jpk, _ = jW.pack_serving_params(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {"blocks": {"ln1": P()}}, backend="jax", tp=1)
    assert isinstance(jpk["blocks"]["ln1"], jW.PackedWeight)
    tpk = tW.pack_serving_params(from_jax_params(tree))
    assert not isinstance(tpk["blocks"]["ln1"], tW.PackedWeight)
    # the same matrix outside a stacked subtree packs in both
    top = tW.pack_serving_params(from_jax_params({"ln1": ones}))
    assert isinstance(top["ln1"], tW.PackedWeight) and top["ln1"].k == 4


# ---------------------------------------------------------------------------
# serving from packed weights
# ---------------------------------------------------------------------------

MAXLEN, SLOTS, BLK = 48, 2, 4


def _runs(codec_on):
    jc = JCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=BLK)
    tc = TCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=BLK)
    return (JRun(codec=dataclasses.replace(jc, weight_backend="jax")),
            TRun(codec=tc))


def _mix(vocab):
    """Trunk-only, trunk + tail replay across a page, more requests than
    slots."""
    rng = np.random.default_rng(4)
    return [(rng.integers(0, vocab, (s,)).astype(np.int32), b)
            for s, b in [(8, 6), (13, 5), (9, 7)]]


def _stream(results):
    return [(r.tokens, r.stop_reason) for r in results]


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_packed_weight_streams(codec_on):
    """The port's ServeEngine(compress_weights=True, device="cpu") against
    the reference's ServeEngine(compress_weights=True, weight_backend=
    "jax") and against the port's raw-weight streams: identical tokens.
    The packed stores agree byte for byte."""
    kw = dataclasses.asdict(tiny_bench_config())
    jcfg, tcfg = JModel(**kw), TModel(**kw)
    jrun, trun = _runs(codec_on)
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=1, pod=1), jrun)
    raw = jPM.init_params(table, jax.random.key(1))
    jpk, _ = jW.pack_serving_params(raw, jPM.param_pspecs(table),
                                    backend="jax", tp=1)
    je = JEngine(jcfg, jrun, tp=1, n_slots=SLOTS, max_len=MAXLEN,
                 params=raw, prefix_sharing=False, max_fuse_steps=1,
                 compress_weights=True)
    mix = _mix(jcfg.vocab_size)
    jres, jst = je.run([JRequest(uid=i, prompt=p, max_new_tokens=b)
                        for i, (p, b) in enumerate(mix)])
    streams = {}
    for packed in (True, False):
        te = TEngine(tcfg, trun, n_slots=SLOTS, max_len=MAXLEN,
                     params=from_jax_params(jax.device_get(raw)),
                     compress_weights=packed, device="cpu")
        res, st = te.run([TRequest(uid=i, prompt=p, max_new_tokens=b)
                          for i, (p, b) in enumerate(mix)])
        streams[packed] = _stream(res)
        assert st.weights_compressed == packed
        assert st.weight_backend == "torch"
        if packed:
            _assert_same_store(jax.device_get(jpk), te.params)
            assert (st.weight_bytes_per_step, st.weight_raw_bytes_per_step) \
                == (jst.weight_bytes_per_step, jst.weight_raw_bytes_per_step)
            assert st.weight_ratio < 0.95
            assert "weights: packed (torch backend)" in format_stats(st)
        else:
            assert st.weight_ratio == 1.0
    assert streams[True] == _stream(jres)
    assert streams[False] == _stream(jres)


# ---------------------------------------------------------------------------
# backend rules
# ---------------------------------------------------------------------------

def test_weight_backend_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    codec = lambda be: dataclasses.replace(TCodec(), weight_backend=be)
    assert ops.resolve_weight_backend(TCodec(), cpu) == "torch"
    assert ops.resolve_weight_backend(None, cpu) == "torch"
    assert ops.resolve_weight_backend(TCodec(), cuda) == "cuda"
    assert ops.resolve_weight_backend(codec("torch"), cpu) == "torch"
    assert ops.resolve_weight_backend(codec("cuda"), cuda) == "cuda"
    assert ops.resolve_weight_backend(codec("unpack"), cuda) == "unpack"
    for be in ("cuda", "unpack"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.resolve_weight_backend(codec(be), cpu)
    with pytest.raises(ValueError, match="CPU tensors"):
        ops.resolve_weight_backend(codec("torch"), cuda)
    for bad in ("jax", "pallas", "zorp"):
        with pytest.raises(ValueError, match="weight_backend"):
            ops.resolve_weight_backend(codec(bad), cpu)
    assert repr(TCodec()) == repr(JCodec())


def test_packed_matmul_refuses_a_backend_off_its_device():
    """No fallback: a packed leaf baked for a kernel backend does not run
    the plain version on CPU tensors, and the kernels refuse CPU tensors;
    the engine refuses a kernel backend on the CPU."""
    from repro_torch.kernels import decompress_matmul, lexi_unpack
    rng = np.random.default_rng(2)
    w = to_torch(_weight_np(rng, (64, 64), 15))
    pw = tW.pack_serving_params({"w": w})["w"]
    x = torch.ones((2, 64), dtype=torch.bfloat16)
    assert torch.equal(tlayers.matmul_f32(x, pw),
                       x.float() @ w.float())
    for be in ("cuda", "unpack"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tlayers.matmul_f32(x, dataclasses.replace(pw, backend=be))
        with pytest.raises(ValueError, match="CUDA tensors"):
            tW.pack_serving_params({"w": w}, backend=be)
    with pytest.raises(ValueError, match="CUDA"):
        decompress_matmul.decompress_matmul(x, pw.signman, pw.planes,
                                            pw.dict_syms, pw.k)
    with pytest.raises(ValueError, match="CUDA"):
        lexi_unpack.lexi_unpack(pw.signman.reshape(1, -1),
                                pw.planes.reshape(1, pw.k, -1),
                                pw.dict_syms.reshape(1, -1), pw.k)
    with pytest.raises(ValueError, match="stack"):
        tlayers.matmul_f32(x, tW.PackedWeight(
            pw.signman[None], pw.planes[None], pw.dict_syms[None], pw.k))
    # moved to the CPU, a kernel backend becomes the CPU's plain one
    moved = to_device({"w": dataclasses.replace(pw, backend="cuda")}, "cpu")
    assert moved["w"].backend == "torch"
    cfg = TModel(**dataclasses.asdict(tiny_bench_config()))
    run = TRun(codec=dataclasses.replace(TCodec(cache_block=BLK),
                                         weight_backend="cuda"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        TEngine(cfg, run, n_slots=1, max_len=16, device="cpu",
                compress_weights=True)
