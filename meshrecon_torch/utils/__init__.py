"""Per-stage timing."""
