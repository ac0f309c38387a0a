import sys

from unicore_tpu_torch.cli import main

sys.exit(main())
