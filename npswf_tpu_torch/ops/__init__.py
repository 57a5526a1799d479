"""Batched ops: matched filter, peak search, cluster gate, spline."""
