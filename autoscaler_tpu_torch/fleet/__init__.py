"""Fleet serving, as far as the port has it: only the shape buckets
(``fleet/buckets.py``), which the resident arena's prewarm ladder and the
options read. The coalescer and the rest of ``autoscaler_tpu/fleet/`` are
not ported (ROADMAP queue 1, the estimator services item).
"""
