"""Long-run support: checkpoint and resume (checkpoint.py)."""
