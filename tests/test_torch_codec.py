"""The PyTorch port's codec against the JAX package: every field of
``compress`` byte-identical on fixed-seed corpora (histogram ties, sizes
that are not multiples of 4096, escape overflow), the plain kernel twins
against ``repro.kernels.ref``, and configs that repr identically.  The
CUDA kernels are held against the plain versions in test_torch_gpu.py."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import entropy as jE
from repro.core import fixed as jfixed
from repro.core import packing as jpacking
from repro.core.collectives import CodecConfig as JCodec
from repro.kernels import ref as jref
from repro_torch import configs as tconfigs
from repro_torch.core import entropy as tE
from repro_torch.core import fixed as tfixed
from repro_torch.core import packing as tpacking
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.kernels import ops, ref as tref
from torch_port_util import bf16_np, bits, to_torch

torch.set_num_threads(2)

FIELDS = ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
          "n_escapes")


def _tie_corpus(n: int) -> np.ndarray:
    """Exactly equal counts for many exponents: the dictionary order is
    decided by the stable tie-break alone."""
    exps = np.arange(90, 90 + 40)                  # 40 exponents, 9 bits
    e = np.resize(exps, n)
    vals = np.exp2(e.astype(np.float64) - 127) * 1.25
    return vals.astype(ml_dtypes.bfloat16)


def _corpus():
    rng = np.random.default_rng(11)
    return {
        "normal-512": (bf16_np(rng, (4, 128)), None),
        "normal-1000": (bf16_np(rng, (1000,), 0.02), None),
        "wide-8192": (bf16_np(rng, (2, 4096), spread=12), None),
        "overflow-300": (bf16_np(rng, (300,), spread=30), 8),
        "overflow-4097": (bf16_np(rng, (4097,), spread=40), None),
        "ties-640": (_tie_corpus(640), None),
        "zeros-96": (np.zeros((96,), ml_dtypes.bfloat16), None),
        "page-256x32": (bf16_np(rng, (256, 32), 0.5, spread=3), None),
    }


CORPUS = _corpus()


@pytest.mark.parametrize("name", sorted(CORPUS))
@pytest.mark.parametrize("k", [4, 5])
def test_compress_byte_identical(name, k):
    x, cap = CORPUS[name]
    want = jfixed.compress(jnp.asarray(x), k=k, esc_capacity=cap)
    got = tfixed.compress(to_torch(x), k=k, esc_capacity=cap)
    for f in FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        assert (bits(a) == bits(b)).all(), f
    assert got.shape == tuple(x.shape) and got.k == k
    assert got.wire_bytes() == want.wire_bytes()
    back = tfixed.decompress(got)
    assert (bits(np.asarray(jfixed.decompress(want))) == bits(back)).all()
    if int(want.n_escapes) <= want.esc_pos.shape[0]:      # lossless
        assert (bits(x) == bits(back)).all()


def test_overflow_cases_do_overflow():
    for name in ("overflow-300", "overflow-4097"):
        x, cap = CORPUS[name]
        ct = tfixed.compress(to_torch(x), k=5, esc_capacity=cap)
        assert int(ct.n_escapes) > ct.esc_pos.shape[0], name


def test_compress_many_equals_vmapped_compress():
    rng = np.random.default_rng(3)
    x = bf16_np(rng, (5, 8, 24), spread=9)
    want = jax.vmap(lambda v: jfixed.compress(v, k=5))(jnp.asarray(x))
    got = tfixed.compress_many(to_torch(x), k=5)
    for f in FIELDS:
        assert (bits(np.asarray(getattr(want, f)))
                == bits(getattr(got, f))).all(), f
    assert (bits(tfixed.decompress(got)) == bits(x)).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_dictionary_ties(seed):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 4, (256,)).astype(np.int32)   # many ties, zeros
    for k in (3, 5, 8):
        wd, wl = jfixed.build_dictionary(jnp.asarray(hist), k)
        td, tl = tfixed.build_dictionary(torch.as_tensor(hist), k)
        assert (np.asarray(wd) == td.numpy()).all()
        assert (np.asarray(wl).astype(np.int64) == tl.numpy()).all()


@pytest.mark.parametrize("k", [1, 4, 5, 8])
def test_bitplane_pack_unpack(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << k, (3, 128)).astype(np.uint32)
    want = np.asarray(jpacking.bitplane_pack(jnp.asarray(codes), k))
    got = tpacking.bitplane_pack(torch.as_tensor(codes.astype(np.int64)), k)
    assert (want == got.numpy().view(np.uint32)).all()
    back = tpacking.bitplane_unpack(got, k)
    assert (back.numpy() == codes).all()
    assert (np.asarray(jpacking.bitplane_unpack(jnp.asarray(want), k))
            == back.numpy()).all()
    assert tpacking.pad_to_lanes(33) == jpacking.pad_to_lanes(33) == 64


def test_field_helpers_match_jnp():
    rng = np.random.default_rng(5)
    x = bf16_np(rng, (257,), spread=60)
    u_j = np.asarray(jE.jnp_to_u16(jnp.asarray(x)))
    u_t = tE.to_u16(to_torch(x))
    assert (u_j.astype(np.int64) == u_t.numpy()).all()
    assert (np.asarray(jE.jnp_signman(jnp.asarray(u_j)))
            == tE.signman(u_t).numpy()).all()
    exp = ((u_j >> 7) & 0xFF).astype(np.uint8)
    sm = np.array(jE.jnp_signman(jnp.asarray(u_j)))
    assert (np.asarray(jE.jnp_combine(jnp.asarray(sm), jnp.asarray(exp)))
            .astype(np.int64) == tE.combine(torch.as_tensor(sm),
                                            torch.as_tensor(exp)).numpy()
            ).all()
    assert (bits(tE.from_u16(u_t)) == bits(x)).all()


def test_histogram_and_pack_twins_match_reference():
    rng = np.random.default_rng(9)
    x = bf16_np(rng, (3, 1000), spread=10)
    for row in range(3):
        want = np.asarray(jref.histogram_ref(jnp.asarray(x[row])))
        got = tref.histogram_ref(to_torch(x))[row].numpy()
        assert (want == got).all()
    hist = jref.histogram_ref(jnp.asarray(x))
    dict_syms, lut = jfixed.build_dictionary(hist, 5)
    xb = np.pad(x.reshape(-1), (0, 3 * 1024 - 3000)).reshape(3, 1024) \
        .astype(ml_dtypes.bfloat16)
    sm_w, pl_w = jref.pack_ref(jnp.asarray(xb), lut, 5)
    lut_t = to_torch(np.asarray(lut).astype(np.int32)).expand(3, 256)
    sm_t, pl_t = ops.pack(to_torch(xb), lut_t.contiguous(), 5)
    assert (np.asarray(sm_w) == sm_t.numpy()).all()
    assert (np.asarray(pl_w) == pl_t.numpy().view(np.uint32)).all()
    un_w = jref.unpack_ref(sm_w, pl_w, dict_syms, 5)
    un_t = tref.unpack_ref(sm_t, pl_t,
                           to_torch(np.asarray(dict_syms)).expand(3, -1), 5)
    assert (bits(np.asarray(un_w)) == bits(un_t)).all()
    assert (ops.histogram(to_torch(x)).numpy()
            == tref.histogram_ref(to_torch(x)).numpy()).all()


def test_wire_ratio_and_codec_repr():
    assert tfixed.wire_ratio() == jfixed.wire_ratio()
    assert tfixed.wire_ratio(4, 64) == jfixed.wire_ratio(4, 64)
    for jc, tc in [(JCodec(), TCodec()), (JCodec.off(), TCodec.off()),
                   (JCodec.weights_only(), TCodec.weights_only()),
                   (JCodec(cache_block=4, k=4), TCodec(cache_block=4, k=4))]:
        assert repr(jc) == repr(tc)
        assert jc.esc_capacity(524288) == tc.esc_capacity(524288)


@pytest.mark.parametrize("arch", sorted(tconfigs._MODULES))
def test_config_repr_identical(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert repr(jc) == repr(tc)
    assert repr(jconfigs.make_reduced(jc)) == repr(tconfigs.make_reduced(tc))
    assert jc.padded_vocab(1) == tc.padded_vocab(1)
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS


def test_backend_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ops.resolve_decode_backend(TCodec(), cpu) == "torch"
    assert ops.resolve_decode_backend(TCodec(), cuda) == "cuda"
    torch_be = dataclasses.replace(TCodec(), decode_backend="torch")
    assert ops.resolve_decode_backend(torch_be, cpu) == "torch"
    with pytest.raises(ValueError, match="CPU tensors"):
        ops.resolve_decode_backend(torch_be, cuda)
    with pytest.raises(ValueError):
        ops.resolve_decode_backend(
            dataclasses.replace(TCodec(), decode_backend="cuda"), cpu)
    with pytest.raises(ValueError):
        ops.resolve_decode_backend(
            dataclasses.replace(TCodec(), decode_backend="pallas"), cpu)


def test_kernel_launchers_refuse_cpu_tensors():
    from repro_torch.kernels import exp_histogram, lexi_pack
    x = torch.zeros((1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        exp_histogram.exp_histogram(x)
    with pytest.raises(ValueError, match="CUDA"):
        lexi_pack.lexi_pack(x, torch.zeros((1, 256), dtype=torch.int32), 5)



def test_port_imports_no_jax_and_no_reference():
    """The port and chip_smoke.py import neither JAX nor ``repro``: by
    source, and at run time in a fresh interpreter."""
    import pathlib
    import re
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        assert not bad.search(f.read_text()), f
    code = ("import sys, repro_torch.serve.scheduler, "
            "repro_torch.launch.serve, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    env = {"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
