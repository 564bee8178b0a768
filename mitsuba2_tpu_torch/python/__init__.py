"""Python-side utilities (test fixtures)."""
