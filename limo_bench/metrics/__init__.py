"""One file per per-layer metric, named after the metric with its dots as
underscores.  Each holds the metric's NAME, UNIT, LAYER, MOVES (the
end-to-end metric it should move) and SOURCE, the SPANS it needs wrapped
((module, function, span label, work counter or None); the harness wraps
each function once, whichever metrics name it), and `read(r)`, which
returns the metric from a `run.Readings` or None where the run has
nothing to read."""
