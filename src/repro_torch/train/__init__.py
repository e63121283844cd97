"""Training (ports ``repro/train``): the optimizer, the train step, LEXI-H
checkpoints and fault tolerance."""
