import sys

from autoscaler_tpu_torch.loadgen.cli import main

if __name__ == "__main__":
    sys.exit(main())
