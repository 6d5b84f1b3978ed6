"""Per-layer metric readers, one file a metric, found by the metric's name.

Each file defines `read(r)`, which takes a `harness.Reading` (one rank's
parsed trace and counts) and returns a number, or None where the run has
nothing to read. `COMBINE` ("mean", the default, or "max") joins the
ranks' numbers in a cell on several cards.
"""
