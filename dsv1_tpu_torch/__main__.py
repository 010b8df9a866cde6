"""`python -m dsv1_tpu_torch e|d ...`: the CLI (dsv1_tpu_torch/cli.py)."""

import sys

from .cli import main

sys.exit(main())
