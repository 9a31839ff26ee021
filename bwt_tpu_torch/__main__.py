import sys

from bwt_tpu_torch.cli import main

sys.exit(main())
