import sys

from tpu_operator_torch.cfg.main import main

sys.exit(main())
