"""``python -m semtools_tpu_torch.soak``: see :mod:`semtools_tpu_torch.soak.campaigns`."""

import sys

from semtools_tpu_torch.soak.campaigns import main

sys.exit(main())
