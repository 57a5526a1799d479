"""The per-batch pipeline and its diagnostics."""
