"""Measurement scripts for the port's kernels, run on the card as
``python -m mitsuba2_tpu_torch.tools.<name>``."""
