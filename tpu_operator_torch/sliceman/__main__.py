import sys

from tpu_operator_torch.sliceman.slice_manager import main

sys.exit(main())
