"""Model diagnostics and their reports (numpy and scipy only)."""
