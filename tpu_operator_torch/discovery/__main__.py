import sys

from tpu_operator_torch.discovery.tfd import main

sys.exit(main())
