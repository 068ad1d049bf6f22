"""`python -m merklekv_tpu_torch.requestplane` — run the pooled router.

A copy of ``merklekv_tpu/requestplane/__main__.py``, its imports pointed at the
port's modules.
"""

import sys

from merklekv_tpu_torch.requestplane.router import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
