"""LEXI-FW codec core (ports ``repro/core``): bf16 fields, bit-plane
packing, the fixed-width codec and its config."""
