"""Input pipelines (ports ``repro/data``)."""
