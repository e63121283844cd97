"""PyTorch/CUDA port of the LEXI serving system (H100).

The JAX package ``repro`` is the reference; every module here sits at the
same relative path as the module it ports and imports neither JAX nor
``repro``.  See README.md, section "PyTorch port (H100)".
"""
