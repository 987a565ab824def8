import sys

from miner_tpu_torch.cli import main

sys.exit(main())
