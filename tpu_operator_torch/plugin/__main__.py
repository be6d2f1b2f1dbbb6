import sys

from tpu_operator_torch.plugin.server import main

sys.exit(main())
