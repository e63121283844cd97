"""Model code of every family, at tp = 1 and tp > 1 (ports
``repro/models``)."""
