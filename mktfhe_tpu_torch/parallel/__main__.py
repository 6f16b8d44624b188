"""python -m mktfhe_tpu_torch.parallel: `launch.main`, the sharded bootstrap
in --world ranks against the single-process one."""

import sys

from .launch import main

if __name__ == "__main__":
    sys.exit(main())
