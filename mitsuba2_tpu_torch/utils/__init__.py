"""File formats (numpy only)."""
