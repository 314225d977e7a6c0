"""``python -m ethzasl_brisk_tpu_torch.parallel worker|dryrun ...``: see
``parallel/multihost.py``."""
import sys

from ethzasl_brisk_tpu_torch.parallel.multihost import main

if __name__ == "__main__":
    sys.exit(main())
