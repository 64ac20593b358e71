"""Host-side camera geometry."""
