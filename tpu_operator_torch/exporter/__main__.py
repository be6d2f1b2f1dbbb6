import sys

from tpu_operator_torch.exporter.exporter import main

sys.exit(main())
