"""``python -m gol_tpu_torch`` — the ``./a.out`` of the PyTorch/CUDA build."""

import sys

from gol_tpu_torch.cli import main

sys.exit(main())
