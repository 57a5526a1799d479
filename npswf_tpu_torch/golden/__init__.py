"""Scalar numpy oracles: the raw-stream decode."""
