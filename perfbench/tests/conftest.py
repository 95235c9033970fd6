"""CPU tests of the benchmark: the registry, the arithmetic, the frozen
reference against the port's plain versions, the import rules, and the
correctness check against planted faults. Tests marked `cuda` run the
controls on a card and skip without one.

    python -m pytest perfbench/tests -q          (on the card: -m cuda)
"""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # perfbench/
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# a tiny farm for the CPU runs of a whole cell
TINY = {"hover.train": {"num_envs": 16, "rollout_steps": 4, "minibatches": 2},
        "mixed4.collect": {"num_envs": 16, "rollout_steps": 4},
        "hover.sim": {"num_envs": 16, "steps": 12}}


@pytest.fixture(scope="session", autouse=True)
def trim_cache(tmp_path_factory):
    """The port's trim cache in a directory of the session's own."""
    old = os.environ.get("HELIGYM_TPU_TORCH_CACHE")
    os.environ["HELIGYM_TPU_TORCH_CACHE"] = str(tmp_path_factory.mktemp("trim"))
    yield
    if old is None:
        os.environ.pop("HELIGYM_TPU_TORCH_CACHE", None)
    else:
        os.environ["HELIGYM_TPU_TORCH_CACHE"] = old


@pytest.fixture
def card():
    """Skips unless a CUDA card is visible (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
