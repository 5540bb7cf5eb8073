"""``python -m declip_tpu_torch.solver``: see declip_tpu_torch/solver."""

from declip_tpu_torch.parallel import shutdown
from declip_tpu_torch.solver import main

if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
