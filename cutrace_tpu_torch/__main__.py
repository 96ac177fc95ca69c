"""`python -m cutrace_tpu_torch <scene.json>` — see cutrace_tpu_torch.cli."""

import sys

from cutrace_tpu_torch.cli import main

sys.exit(main())
