"""Launchers (ports ``repro/launch``)."""
