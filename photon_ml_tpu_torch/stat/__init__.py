"""Feature summary statistics."""
