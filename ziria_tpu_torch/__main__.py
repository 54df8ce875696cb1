"""``python -m ziria_tpu_torch``: the port's CLI driver
(runtime/cli.py)."""

import sys

from ziria_tpu_torch.runtime.cli import main

sys.exit(main())
