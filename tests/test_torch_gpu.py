"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker ``gpu``; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has no JAX.  tests/conftest.py imports JAX, so run
it there with ``--noconftest``:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import fixed, weights
from repro_torch.core.collectives import CodecConfig
from repro_torch.kernels import decompress_matmul, lexi_unpack, ops, ref
from repro_torch.serve.scheduler import Request, ServeEngine

pytestmark = pytest.mark.gpu

FIELDS = ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
          "n_escapes")
# the kernels a raw-weight serve runs: attention and the page codec
ATTEND_PATH_KERNELS = ("decode_attend_paged", "exp_histogram", "lexi_pack")


@pytest.fixture()
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels run only on "
                    "the card)")
    return torch.device("cuda")


def _bf16(gen, shape, spread=0, device="cuda"):
    """Normal bf16 values; ``spread`` > 0 scales each by 2^U[-s, s)."""
    x = torch.randn(shape, generator=gen, device=device)
    if spread:
        x = x * torch.exp2(torch.randint(-spread, spread, shape,
                                         generator=gen, device=device).float())
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("n", [524288, 524288 + 96, 1000])
def test_codec_kernels_match_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = _bf16(gen, (6, n), spread=20)
    before = ops.launch_counts()
    hist = ops.histogram(x)
    assert torch.equal(hist, ref.histogram_ref(x))
    _, lut = fixed.build_dictionary(hist, 5)
    sm, pl = ops.pack(x, lut, 5)
    sm_p, pl_p = ref.pack_ref(x, lut, 5)
    assert torch.equal(sm, sm_p) and torch.equal(pl, pl_p)
    after = ops.launch_counts()
    assert after["exp_histogram"] == before["exp_histogram"] + 1
    assert after["lexi_pack"] == before["lexi_pack"] + 1
    ct = fixed.compress_many(x, k=5)
    ct_cpu = fixed.compress_many(x.cpu(), k=5)
    for f in FIELDS:
        assert torch.equal(getattr(ct, f).cpu(), getattr(ct_cpu, f)), f


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("heads", [(4, 2), (5, 1), (8, 8), (32, 8)],
                         ids=["gqa", "mqa", "mha", "qwen3"])
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_decode_attend_kernel_matches_plain(cuda, heads, hd, codec_on):
    """Per-slot lengths incl. 0 and 2 tokens, unmapped table entries, a
    page with escapes past capacity; full and windowed; softcap."""
    h, hkv = heads
    blk, maxp, n_pages = 16, 4, 11
    w = 2 * hkv * hd
    gen = torch.Generator(device=cuda).manual_seed(h * hd)
    pages = _bf16(gen, (n_pages, blk, w))
    pages[0] = _bf16(gen, (blk, w), spread=40)               # overflow
    ring = _bf16(gen, (5, blk, w))
    q = _bf16(gen, (5, h, hd))
    table = torch.randint(0, n_pages, (5, maxp), generator=gen, device=cuda,
                          dtype=torch.int32)
    table[0, 0] = 0
    table[1, 1:] = -1
    lengths = torch.tensor([3 * blk + 5, 2, 0, maxp * blk, blk],
                           dtype=torch.int32, device=cuda)
    if codec_on:
        ct = fixed.compress_many(pages, k=5)
        assert int(ct.n_escapes[0]) > ct.esc_pos.shape[-1]
        pool = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
                None)
    else:
        pool = (None,) * 5 + (pages,)
    g = h // hkv
    kv_idx = tuple(min(i // g, hkv - 1) for i in range(h))
    for window, softcap in ((ref.WINDOW_NONE, None), (21, None),
                            (ref.WINDOW_NONE, 30.0)):
        args = (q, *pool, ring, table.clamp(min=0), lengths, window)
        kw = dict(k=5, kv_idx=kv_idx, scale=hd ** -0.5, softcap=softcap)
        o_k, m_k, l_k = ops.decode_attend_paged(*args, **kw)
        o_p, m_p, l_p = ref.paged_decode_attend_plain(*args, **kw)
        torch.testing.assert_close(o_k / l_k.clamp(min=1e-30)[..., None],
                                   o_p / l_p.clamp(min=1e-30)[..., None],
                                   rtol=1e-4, atol=1e-4)
        live = l_p > 0
        torch.testing.assert_close(m_k[live], m_p[live], rtol=1e-5,
                                   atol=1e-5)


TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=512,
                   head_dim=16, qk_norm=True)


def _tiny_requests():
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, 512, (s,)).astype(np.int32),
                    max_new_tokens=b)
            for i, (s, b) in enumerate([(8, 5), (13, 6), (4, 9), (23, 4)])]


def test_engine_serves_on_card_with_every_kernel(cuda):
    """A tiny dense model through ServeEngine's default device: every
    request gets its budget and the attention path's three kernels
    launch (raw weights: the weight plane's two do not)."""
    run = RunConfig(codec=dataclasses.replace(CodecConfig(), cache_block=4))
    eng = ServeEngine(TINY, run, n_slots=2, max_len=48, seed=1)
    assert eng.device.type == "cuda" and eng.decode_backend == "cuda"
    reqs = _tiny_requests()
    ops.reset_launch_counts()
    results, st = eng.run(reqs)
    assert [len(r.tokens) for r in results] == [5, 6, 9, 4]
    counts = ops.launch_counts()
    assert all(counts[name] > 0 for name in ATTEND_PATH_KERNELS), counts
    assert counts["decompress_matmul"] == counts["lexi_unpack"] == 0
    assert st.peak_cache_bytes < st.peak_cache_raw_bytes


# ---------------------------------------------------------------------------
# the packed weight plane: lexi_unpack and decompress_matmul
# ---------------------------------------------------------------------------

# (K, N) of qwen3-4b's weights: wq, wk/wv, wo, w_gate/w_up, w_down, lm_head
QWEN3_4B_WEIGHTS = [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728),
                    (9728, 2560), (2560, 151936)]


def _weight(gen, shape, k):
    """bf16 weights with at most 2^k - 1 distinct exponents (random sign
    and mantissa): escape-free at k, so the packed form is exact."""
    e = torch.randint(-8, (1 << k) - 9, shape, generator=gen, device="cuda")
    m = 1 + torch.randint(0, 128, shape, generator=gen, device="cuda") / 128
    s = torch.randint(0, 2, shape, generator=gen, device="cuda") * 2 - 1
    return (s * m * torch.exp2(e.float())).to(torch.bfloat16)


def _i16(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("k", [4, 5, 6])
@pytest.mark.parametrize("g,n", [(3, 32 * 37), (2, 1000), (1, 2560 * 9728)],
                         ids=["rows", "ragged", "qwen3-w_gate"])
def test_lexi_unpack_kernel_matches_plain(cuda, g, n, k):
    """Arbitrary bits (every code, every signman byte, a dictionary per
    row): bit for bit, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(g * n + k)
    sm = torch.randint(0, 256, (g, n), generator=gen, device=cuda,
                       dtype=torch.uint8)
    planes = torch.randint(-(1 << 31), 1 << 31, (g, k, -(-n // 32)),
                           generator=gen, device=cuda, dtype=torch.int32)
    dicts = torch.randint(0, 256, (g, 1 << k), generator=gen, device=cuda,
                          dtype=torch.uint8)
    before = lexi_unpack.launches
    got = ops.unpack_rows(sm, planes, dicts, k)
    assert lexi_unpack.launches == before + 1
    assert torch.equal(_i16(got), _i16(ref.unpack_ref(sm, planes, dicts, k)))


@pytest.mark.parametrize("spread", [9, 40], ids=["escapes", "overflow"])
def test_ops_unpack_matches_decompress(cuda, spread):
    """The kernel-backed decompress patches the escape side channel as
    fixed.decompress does, within and past its capacity."""
    gen = torch.Generator(device=cuda).manual_seed(spread)
    x = _bf16(gen, (6, 256, 512), spread=spread)
    ct = fixed.compress_many(x, k=5, esc_capacity=64)
    assert int(ct.n_escapes.max()) > 0
    assert (int(ct.n_escapes.max()) > 64) == (spread == 40)
    assert torch.equal(_i16(ops.unpack(ct)), _i16(fixed.decompress(ct)))


def _dm_check(gen, m, kk, n, k):
    w = _weight(gen, (kk, n), k)
    sm, pl, d, n_esc = ops.compress_weight(w, k=k)
    assert int(n_esc) == 0
    x = _bf16(gen, (m, kk))
    before = decompress_matmul.launches
    got = ops.matmul_compressed(x, sm, pl, d, k=k)
    assert decompress_matmul.launches == before + 1
    want = ref.decompress_matmul_ref(x, sm, pl, d, k)
    # the products are exact in f32: only the summation order differs
    tol = 1e-4 * (x.float().abs() @ w.float().abs()) + 1e-6
    assert got.shape == (m, n) and bool(((got - want).abs() <= tol).all())
    assert bool(((got - x.float() @ w.float()).abs() <= tol).all())


@pytest.mark.parametrize("k", [4, 5, 6])
@pytest.mark.parametrize("m,kk,n", [(1, 1, 32), (37, 301, 32 * 9),
                                    (130, 64, 160), (5, 1000, 32 * 33),
                                    (64, 128, 128)])
def test_decompress_matmul_kernel_matches_plain(cuda, m, kk, n, k):
    """Ragged M, K and N tiles (masked in the kernel), odd K (element-wise
    x loads), tile-exact shapes."""
    _dm_check(torch.Generator(device=cuda).manual_seed(m * kk + n + k),
              m, kk, n, k)


@pytest.mark.parametrize("m", [4, 1024], ids=["decode", "prefill"])
@pytest.mark.parametrize("kk,n", QWEN3_4B_WEIGHTS,
                         ids=[f"{a}x{b}" for a, b in QWEN3_4B_WEIGHTS])
def test_decompress_matmul_kernel_qwen3_shapes(cuda, kk, n, m):
    _dm_check(torch.Generator(device=cuda).manual_seed(kk + n + m),
              m, kk, n, 5)


def test_engine_serves_packed_weights_on_card(cuda):
    """ServeEngine(compress_weights=True) on the card: the ``unpack``
    backend launches lexi_unpack (and not decompress_matmul) and gives
    the raw weights' streams; the ``cuda`` backend launches
    decompress_matmul (and not lexi_unpack).  Every request gets its
    budget on both."""
    streams = {}
    for be in ("raw", "unpack", "cuda"):
        codec = dataclasses.replace(CodecConfig(), cache_block=4,
                                    weight_backend="auto" if be == "raw"
                                    else be)
        eng = ServeEngine(TINY, RunConfig(codec=codec), n_slots=2, max_len=48,
                          seed=1, compress_weights=be != "raw")
        ops.reset_launch_counts()
        results, st = eng.run(_tiny_requests())
        counts = ops.launch_counts()
        assert [len(r.tokens) for r in results] == [5, 6, 9, 4]
        streams[be] = [r.tokens for r in results]
        if be == "raw":
            assert counts["decompress_matmul"] == counts["lexi_unpack"] == 0
            continue
        assert st.weight_backend == be and st.weight_ratio < 0.95
        assert isinstance(eng.params["lm_head"], weights.PackedWeight)
        used, idle = (("lexi_unpack", "decompress_matmul") if be == "unpack"
                      else ("decompress_matmul", "lexi_unpack"))
        assert counts[used] > 0 and counts[idle] == 0, counts
    assert streams["unpack"] == streams["raw"]
    with pytest.raises(ValueError, match="CPU tensors"):
        ServeEngine(TINY, RunConfig(codec=dataclasses.replace(
            CodecConfig(), cache_block=4, weight_backend="torch")),
            n_slots=2, max_len=48, compress_weights=True)
