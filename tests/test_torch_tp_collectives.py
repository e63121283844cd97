"""The port's collectives (``repro_torch.core.collectives``) on spawned
gloo ranks against the reference's under ``shmap`` on as many of
conftest's fake CPU devices, at world 2 and 4, on the same numpy-seeded
inputs: ``compressed_all_gather`` (tiled and untiled, axes 0, 1 and -1),
``compressed_psum`` (with and without a divisible axis),
``compressed_all_to_all``, ``compressed_ppermute``, and the plain bf16
psum / psum_scatter (their summation order) and pmax / pmin.  Every
output bit-identical to the reference's, inputs with escape overflow
included (the reference's round trip is lossy there, and so is the
port's, the same way); every rank's wire bytes equal to the reference's
``fixed.compress`` of the same part, field for field.

Each world size is one spawn of its ranks (``launch.mesh.spawn`` running
``launch.tp_jobs.collectives``, which imports no JAX) for all its cases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import collectives as jcl
from repro.core import fixed as jfixed
from repro_torch.core import collectives as tcl
from repro_torch.launch import mesh, tp_jobs
from torch_port_util import bf16_np

torch.set_num_threads(2)

OFF = dataclasses.replace(tcl.CodecConfig(), enabled=False)


def _cases(n: int):
    """(name, op, per-rank input (n, ...), keywords) for world n."""
    rng = np.random.default_rng(n)
    x = lambda shape, spread=6: bf16_np(rng, (n,) + shape, 1.0, spread)
    ring = [(i, (i + 1) % n) for i in range(n)]
    out = []
    for ax in (0, 1, -1):
        for tiled in (True, False):
            out.append((f"all_gather-ax{ax}-{'tiled' if tiled else 'new'}",
                        "all_gather", x((4, 6, 32)),
                        dict(gather_axis=ax, tiled=tiled)))
    out += [
        ("all_gather-overflow", "all_gather", x((4, 64), spread=60),
         dict(gather_axis=1)),
        ("all_gather-ragged", "all_gather", x((3, 7)), dict(gather_axis=0)),
        ("psum", "psum", x((4 * n, 6, 32)), {}),
        ("psum-axis2", "psum", x((3, 5, 8 * n)), dict(scatter_axis=2)),
        ("psum-overflow", "psum", x((2 * n, 64), spread=60), {}),
        ("psum-no-divisible-axis", "psum", x((3, 5, 7)), {}),
        ("all_to_all", "all_to_all", x((2 * n, 6, 32)), {}),
        ("all_to_all-split1-concat2", "all_to_all", x((3, 4 * n, 8)),
         dict(split_axis=1, concat_axis=2)),
        ("all_to_all-overflow", "all_to_all", x((n, 64, 8), spread=60), {}),
        ("ppermute-ring", "ppermute", x((4, 6, 32)), dict(perm=ring)),
        ("ppermute-one-pair", "ppermute", x((5, 32), spread=60),
         dict(perm=[(0, n - 1)])),
        ("psum_plain-bf16", "psum_plain", x((64, 33), spread=3), {}),
        ("psum_scatter-bf16", "psum_scatter", x((2, 8 * n, 16), spread=3),
         dict(axis=1)),
        ("pmax", "pmax", x((16, 9)), {}),
        ("pmin", "pmin", x((16, 9)), {}),
    ]
    return out


def _ref_one(op: str, x, kw):
    """The reference's collective on this shard's ``x`` (inside shmap)."""
    codec = jcl.CodecConfig()
    if op == "all_gather":
        return jcl.compressed_all_gather(x, "model", codec, **kw)
    if op == "psum":
        return jcl.compressed_psum(x, "model", codec, **kw)
    if op == "all_to_all":
        return jcl.compressed_all_to_all(x, "model", codec, **kw)
    if op == "ppermute":
        return jcl.compressed_ppermute(x, "model", tuple(kw["perm"]), codec)
    if op == "psum_plain":
        return jax.lax.psum(x, "model")
    if op == "psum_scatter":
        return jax.lax.psum_scatter(x, "model", scatter_dimension=kw["axis"],
                                    tiled=True)
    if op == "pmax":
        return jax.lax.pmax(x, "model")
    return jax.lax.pmin(x, "model")


def _ref(calls, n: int):
    """The reference's collectives under one shmap on n devices: for each
    (op, per-rank inputs (n, ...), keywords), the per-rank outputs
    stacked."""
    mesh_ = jax.make_mesh((n,), ("model",))

    def body(*xs):
        return tuple(_ref_one(op, x[0], kw)[None]
                     for (op, _, kw), x in zip(calls, xs))

    spec = tuple(P("model") for _ in calls)
    f = jax.jit(jcl.shmap(body, mesh_, spec, spec))
    return [np.asarray(y) for y in f(*(jnp.asarray(xs)
                                      for _, xs, _ in calls))]


def _ref_wire(x: np.ndarray, codec=jcl.CodecConfig()) -> np.ndarray:
    """The reference's ``fixed.compress`` of one part, its fields back to
    back (the port's wire layout)."""
    ct = jfixed.compress(jnp.asarray(x), k=codec.k,
                         esc_capacity=codec.esc_capacity(x.size))
    return np.concatenate([np.asarray(f).reshape(-1).view(np.uint8) for f in
                           (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos,
                            ct.esc_raw, ct.n_escapes)])


def _pair(a: np.ndarray):
    return ("bf16", a.view(np.uint16))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    n = request.param
    cases = _cases(n)
    jobs = [dict(op=op, xs=[_pair(xs[r]) for r in range(n)], kw=kw)
            for _, op, xs, kw in cases]
    # the codec off: the plain collective, also bit for bit
    jobs.append(dict(op="all_gather", xs=jobs[0]["xs"], kw=cases[0][3],
                     codec=OFF))
    got = mesh.spawn(tp_jobs.collectives, n, backend="gloo",
                     args=(jobs,))
    want = _ref([(op, xs, kw) for _, op, xs, kw in cases]
                # the psum cases' reduce-scattered parts (their wire)
                + [("psum_scatter", xs, dict(axis=kw.get("scatter_axis", 0)))
                   for name, op, xs, kw in cases
                   if op == "psum" and "no-divisible" not in name], n)
    return n, cases, got, want


CASE_NAMES = [c[0] for c in _cases(2)]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_matches_reference_bit_for_bit(world, name):
    n, cases, got, wants = world
    i = CASE_NAMES.index(name)
    want = wants[i]
    for r in range(n):
        y = got[r][i]["y"]
        y = y[1].view(ml_dtypes.bfloat16) if isinstance(y, tuple) else y
        assert y.shape == want[r].shape, (r, y.shape, want[r].shape)
        assert (y.view(np.uint8) == want[r].view(np.uint8)).all(), r


@pytest.mark.parametrize("name", [c for c in CASE_NAMES
                                  if c.startswith(("all_gather", "psum-",
                                                   "psum", "all_to_all",
                                                   "ppermute"))
                                  and "plain" not in c
                                  and "scatter" not in c])
def test_wire_bytes_are_the_reference_compress(world, name):
    """The bytes each rank puts on the wire are the reference's
    ``fixed.compress`` of its part: the whole shard (all_gather,
    ppermute), its reduce-scattered chunk (psum) or each destination's
    slice (all_to_all)."""
    n, cases, got, wants = world
    i = CASE_NAMES.index(name)
    _, op, xs, kw = cases[i]
    psums = [c[0] for c in cases
             if c[1] == "psum" and "no-divisible" not in c[0]]
    for r in range(n):
        wires = got[r][i]["wire"]
        if op in ("all_gather", "ppermute"):
            parts = [xs[r]]
        elif op == "psum":
            if name == "psum-no-divisible-axis":
                assert wires == [], "a plain psum moves nothing compressed"
                continue
            parts = [wants[len(cases) + psums.index(name)][r]]
        else:
            sa = kw.get("split_axis", 0)
            xm = np.moveaxis(xs[r], sa, 0)
            parts = list(xm.reshape((n, xm.shape[0] // n) + xm.shape[1:]))
        assert len(wires) == 1 and wires[0].shape[0] == len(parts)
        for j, part in enumerate(parts):
            assert (wires[0][j] == _ref_wire(part)).all(), (r, j)
    if "overflow" in name:
        ct = jfixed.compress(jnp.asarray(xs[0]))
        assert int(ct.n_escapes) > ct.esc_pos.shape[0], "no overflow"


def test_codec_off_is_the_plain_gather(world):
    n, cases, got, wants = world
    want = wants[0]
    for r in range(n):
        y = got[r][-1]["y"][1].view(ml_dtypes.bfloat16)
        assert (y.view(np.uint8) == want[r].view(np.uint8)).all()
        assert got[r][-1]["wire"] == []
