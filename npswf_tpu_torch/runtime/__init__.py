"""The segment executor."""
