"""Command-line tools: the run/synth/validate CLI and the validator."""
