"""The views of a run (``chsimpy_tpu/viz``): the six-panel diagnostics
window (:mod:`.plotview`) and the bare field map of ``--no-diagrams`` and
the experiment's live view (:mod:`.mapview`).  Host-only; matplotlib is
imported when a view is built."""
