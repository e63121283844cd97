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
from repro_torch.core import fixed
from repro_torch.core.collectives import CodecConfig
from repro_torch.kernels import ops, ref
from repro_torch.serve.scheduler import Request, ServeEngine

pytestmark = pytest.mark.gpu

FIELDS = ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
          "n_escapes")


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


def test_engine_serves_on_card_with_every_kernel(cuda):
    """A tiny dense model through ServeEngine's default device: every
    request gets its budget and all three kernels launch."""
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=512,
                      head_dim=16, qk_norm=True)
    run = RunConfig(codec=dataclasses.replace(CodecConfig(), cache_block=4))
    eng = ServeEngine(cfg, run, n_slots=2, max_len=48, seed=1)
    assert eng.device.type == "cuda" and eng.decode_backend == "cuda"
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, 512, (s,)).astype(np.int32),
                    max_new_tokens=b)
            for i, (s, b) in enumerate([(8, 5), (13, 6), (4, 9), (23, 4)])]
    ops.reset_launch_counts()
    results, st = eng.run(reqs)
    assert [len(r.tokens) for r in results] == [5, 6, 9, 4]
    assert all(v > 0 for v in ops.launch_counts().values())
    assert st.peak_cache_bytes < st.peak_cache_raw_bytes
