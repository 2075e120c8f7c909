"""Shared helpers of the benchmark's CPU tests: the cells at a size a test
run holds."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# several test processes share the host: two threads each keep a short
# window to a few frames of each cell
torch.set_num_threads(2)

# every cell at a golden size: 96x54, 20 km, tiles of 121 posts
SMALL = {"width": 96, "height": 54, "max_distance": 20000.0, "posts": 121}
CELLS = ("headline_1080p.fast_pan", "objects_1080p.fast_sector",
         "headline_1080p.rect_tilt1_pan", "headline_1080p.rect_tilt0_pan",
         "translucent_1080p.fast_sector", "objects_1080p.rect_tilt0_sector")
SEED = 2**31 + 977


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels run only there)")
    return torch.device("cuda:0")
