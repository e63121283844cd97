"""Dense decoder model code at tp = 1 (ports ``repro/models``)."""
