"""``python -m mitsuba2_tpu_torch``: the command-line renderer
(cli.py)."""

import sys

from .cli import main

sys.exit(main())
