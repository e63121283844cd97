"""LEXI quickstart on PyTorch: the paper's observation and codec in a
minute (ports ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``--device cuda`` (the default) runs the hand-written kernels on the
card; ``--device cpu`` runs their plain versions.  Section 5 spawns two
ranks over gloo (on one card they share it).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    from repro_torch.core import codec, entropy, fixed
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import resolve_device

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- 1. the observation (paper section 3 / Fig 1) ---------------------
    weights = rng.normal(0, 0.02, 1_000_000).astype(np.float32)
    prof = entropy.profile_exponents(weights)
    print(f"BF16 exponent entropy : {prof.exp_entropy_bits:.2f} bits  "
          f"(paper: < 3)")
    print(f"distinct exponents    : {prof.distinct_exponents}  "
          f"(paper: < 32)")
    print(f"mantissa entropy      : {prof.man_entropy_bits:.2f} bits "
          f"(incompressible)")
    print(f"LEXI-H exponent CR    : {prof.exp_cr:.2f}x  (paper: ~3.1x)")
    print(f"whole-value CR        : {prof.overall_cr:.2f}x")

    # --- 2. Table 2: LEXI vs RLE vs BDI ------------------------------------
    crs = codec.measure_crs(weights)
    print(f"\nTable 2 on this tensor: RLE {crs['rle']:.2f}x  "
          f"BDI {crs['bdi']:.2f}x  LEXI {crs['lexi']:.2f}x")

    # --- 3. the deployment codec (LEXI-FW): lossless ------------------------
    x = torch.as_tensor(rng.normal(0, 1, (256, 1024)), dtype=torch.float32,
                        device=dev).to(torch.bfloat16)
    ct = fixed.compress(x)
    xr = fixed.decompress(ct)
    exact = torch.equal(x.view(torch.int16), xr.view(torch.int16))
    print(f"\nLEXI-FW roundtrip bit-exact: {exact}; wire ratio "
          f"{x.numel() * 2 / ct.wire_bytes():.3f}x; escapes "
          f"{int(ct.n_escapes)}")

    # --- 4. the kernels (on the card; plain versions on the CPU) -----------
    hist = ops.histogram(x.reshape(1, -1))
    print(f"exp_histogram kernel: {int(hist.sum())} values binned "
          f"(== {x.numel()})")
    w = torch.as_tensor(rng.normal(0, 0.02, (256, 512)), dtype=torch.float32,
                        device=dev).to(torch.bfloat16)
    sm, pl, d, nesc = ops.compress_weight(w)
    xa = x[:64, :256].contiguous()           # the kernel takes dense rows
    out = ops.matmul_compressed(xa, sm, pl, d)
    ref = xa.float() @ w.float()
    print(f"decompress_matmul max err vs plain matmul: "
          f"{float((out - ref).abs().max()):.2e} (K-block accum order only)")
    print(f"launches: {ops.launch_counts()} on {dev}")

    # --- 5. compressed collective ------------------------------------------
    from repro_torch.core.collectives import CodecConfig
    from repro_torch.launch import mesh, tp_jobs

    n = 2
    xs = torch.as_tensor(rng.normal(0, 1, (n * 8, 128)),
                         dtype=torch.float32).to(torch.bfloat16)
    parts = [tp_jobs.to_numpy(p) for p in xs.chunk(n)]
    ranks = mesh.spawn(tp_jobs.collectives, n, backend="gloo",
                       device=str(dev), args=([dict(
                           op="all_gather", xs=parts, codec=CodecConfig(),
                           kw=dict(gather_axis=0))], str(dev)))
    got = tp_jobs.to_tensor(ranks[0][0]["y"])
    wire = sum(int(w_.size) for w_ in ranks[0][0]["wire"])
    print(f"compressed all_gather on {n} ranks: "
          f"{torch.equal(got.view(torch.int16), xs.view(torch.int16))} "
          f"(bit-exact), rank 0 put {wire} B on the wire for "
          f"{xs.numel() // n * 2} B of raw bf16 "
          f"(~{xs.numel() // n * 2 / max(wire, 1):.2f}x)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
