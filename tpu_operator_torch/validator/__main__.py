import sys

from tpu_operator_torch.validator.main import main

sys.exit(main())
