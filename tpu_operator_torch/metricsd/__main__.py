import sys

from tpu_operator_torch.metricsd.daemon import main

sys.exit(main())
