"""CPU tests of the benchmark (run with ``python -m pytest benchmark/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the
``cuda_card`` fixture, which decides when the test runs, never when a
module is imported, whether a card is there; the chip runs them with
``python -m pytest benchmark/tests -m card``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small sizes for the CPU: every width of the configuration but the neck's
# (64 for 4096), with small images, buckets and banks, in float32
TINY = {"MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM": 64, "TPU.PROPOSAL_BUCKETS": [32],
        "INPUT.MIN_SIZE_TRAIN": [64, 80], "INPUT.MAX_SIZE_TRAIN": 160,
        "TPU.IMAGE_PAD_MULTIPLE": 32, "TPU.COMPUTE_DTYPE": "float32",
        "TPU.BANK_CAPACITY": 64, "INPUT.MIN_SIZE_TEST": 64,
        "INPUT.MAX_SIZE_TEST": 120, "TEST.BBOX_AUG.SCALES": [80],
        "TEST.BBOX_AUG.MAX_SIZE": 160, "DATALOADER.NUM_WORKERS": 2}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips on the CPU)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this host has none")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    return dict(TINY)
