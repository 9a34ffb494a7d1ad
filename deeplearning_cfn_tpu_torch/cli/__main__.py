"""``python -m deeplearning_cfn_tpu_torch.cli`` → the port's command line."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
