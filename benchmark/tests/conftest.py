import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

# tiny runs: one intra-op thread a worker, so that parallel workers do not
# oversubscribe the host
torch.set_num_threads(1)
