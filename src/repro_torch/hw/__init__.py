"""Hardware models of the paper's codec and chiplet platform (ports
``repro/hw``).  Only ``noc`` is ported so far: the page transport meters
its handoffs through ``noc.LinkModel``.  ``area``, ``lanecache`` and
``lut_decoder`` wait for the analysis stack."""
from . import noc  # noqa: F401
