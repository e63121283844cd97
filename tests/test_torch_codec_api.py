"""The port's numpy analysis modules against the reference's on seeded
inputs: ``core/baselines.py`` (RLE and BDI bit counts and ratios),
``core/entropy.py``'s Fig-1 profile (``to_bf16_u16``,
``profile_exponents``) and ``core/codec.py`` (``measure_crs``,
``overall_bf16_ratio``, ``LexiCodec`` streams and whole-tensor
containers): equal numbers, equal bytes."""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase, codec as jcodec
from repro.core import entropy as jent
from repro_torch.core import baselines as tbase, codec as tcodec
from repro_torch.core import entropy as tent

torch.set_num_threads(2)


def _inputs():
    """Seeded tensors: weights N(0, 0.02), activations N(0, 1) in bf16,
    a wide spread of exponents, long runs, and ragged sizes."""
    rng = np.random.default_rng(0)
    return {
        "weights": rng.normal(0, 0.02, 20000).astype(np.float32),
        "acts": rng.normal(0, 1, (64, 96)).astype(ml_dtypes.bfloat16),
        "spread": (rng.normal(0, 1, 5001)
                   * np.exp2(rng.integers(-40, 40, 5001))),
        "runs": np.repeat(rng.normal(0, 1, 40), 300).astype(np.float32),
        "tiny": np.asarray([0.5, -2.0, 3.0], np.float32),
    }


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_baselines_identical(name):
    exp = jent.split_fields(jent.to_bf16_u16(_inputs()[name]))[1]
    assert tbase.rle_bits(exp) == jbase.rle_bits(exp)
    assert tbase.rle_cr(exp) == jbase.rle_cr(exp)
    for block in (32, 16, 7):
        assert tbase.bdi_bits(exp, block=block) == \
            jbase.bdi_bits(exp, block=block)
    assert tbase.bdi_cr(exp) == jbase.bdi_cr(exp)
    assert tbase.rle_bits(exp[:0]) == jbase.rle_bits(exp[:0]) == 0


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_profile_and_crs_identical(name):
    x = _inputs()[name]
    u = tent.to_bf16_u16(x)
    assert u.dtype == np.uint16 and (u == jent.to_bf16_u16(x)).all()
    assert (tent.to_bf16_u16(torch.from_numpy(
        np.asarray(x, np.float32))) == jent.to_bf16_u16(
            np.asarray(x, np.float32))).all()
    assert dataclasses.asdict(tent.profile_exponents(x)) == \
        dataclasses.asdict(jent.profile_exponents(x))
    p = tent.profile_exponents(x)
    q = jent.profile_exponents(x)
    assert (p.exp_cr, p.overall_cr) == (q.exp_cr, q.overall_cr)
    assert tcodec.measure_crs(x) == jcodec.measure_crs(x)
    for cr in (0.64, 2.4, 3.1):
        assert tcodec.overall_bf16_ratio(cr) == jcodec.overall_bf16_ratio(cr)


@pytest.mark.parametrize("name", ["weights", "acts", "spread"])
def test_lexi_codec_identical(name):
    """LexiCodec fit on the first 512 exponents, then the first 4096
    encoded: the same codebook, payload bytes and decoded stream; the
    whole-tensor container byte for byte, and its inverse bit for bit."""
    x = _inputs()[name]
    exp = jent.split_fields(jent.to_bf16_u16(x))[1].reshape(-1)[:4096]
    tc, jc = tcodec.LexiCodec().fit(exp), jcodec.LexiCodec().fit(exp)
    ts, js = tc.encode(exp), jc.encode(exp)
    assert ts.payload == js.payload and ts.total_bits == js.total_bits
    assert (ts.book.lengths == js.book.lengths).all()
    assert (tc.decode(ts) == jc.decode(js)).all()
    assert (tc.decode(ts) == exp).all()
    small = np.asarray(x).reshape(-1)[:3000]
    blob = tcodec.LexiCodec.compress_tensor(small)
    assert blob == jcodec.LexiCodec.compress_tensor(small)
    back = tcodec.LexiCodec.decompress_tensor(blob, small.shape)
    assert back.dtype == torch.bfloat16
    assert (back.view(torch.int16).numpy().view(np.uint16)
            == jent.to_bf16_u16(small)).all()
