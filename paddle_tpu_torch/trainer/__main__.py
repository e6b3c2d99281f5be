"""``python -m paddle_tpu_torch.trainer --config=conf.py [--job=...]``:
the paddle_trainer command line of the port (``trainer.main``)."""

import sys

from paddle_tpu_torch.trainer.trainer import main

sys.exit(main())
