"""The port's examples at a tiny size on the CPU, in subprocesses (each
spawns its ranks): ``examples/torch_quickstart.py`` (the entropy
profile, Table 2, the LEXI-FW round trip, both kernels' plain versions,
a compressed all-gather over two gloo ranks) and
``examples/torch_serve_lm.py`` in its fixed-batch, continuous and
disaggregated tp = 2 modes."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          "--device", "cpu", *args], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    return out.stdout


def test_quickstart():
    out = _run("torch_quickstart.py")
    assert "LEXI-FW roundtrip bit-exact: True" in out
    assert "decompress_matmul max err vs plain matmul" in out
    assert "compressed all_gather on 2 ranks: True (bit-exact)" in out
    assert "Table 2 on this tensor: RLE" in out


SERVE = {"fixed": [], "continuous": ["--continuous"],
         "disagg-tp2": ["--disagg", "--tp", "2", "--dist-backend", "gloo"]}


@pytest.mark.parametrize("mode", sorted(SERVE))
def test_serve_lm(mode):
    out = _run("torch_serve_lm.py", "--arch", "qwen3-4b", "--prompt-len",
               "16", "--new-tokens", "4", "--requests", "3",
               *SERVE[mode])
    assert "continuations[0][:10]" in out
    if mode == "fixed":
        assert "weights at rest" in out and "steady state" in out
    if mode == "disagg-tp2":
        assert "prefill -> 1 decode replicas" in out
