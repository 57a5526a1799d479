"""Host-side helpers: synthetic events with known truth."""
