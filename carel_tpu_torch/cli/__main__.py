import sys

from carel_tpu_torch.cli.main import main

sys.exit(main())
