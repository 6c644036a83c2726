"""``python -m mvapich2_tpu_torch.run -np N prog args...``: the ``mpirun``
entry point (``runtime/launcher.py``)."""

import sys

from .runtime.launcher import main

if __name__ == "__main__":
    sys.exit(main())
