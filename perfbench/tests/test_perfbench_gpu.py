"""On the card: the tiny cells through the CUDA kernels, judged by the
plain references, and the control failing the check at a size a test run
holds.  Marked ``gpu``; each test decides inside itself whether a card
is there.  On the card, from the root of a checkout:

    python -m pytest -m gpu perfbench/tests/test_perfbench_gpu.py
"""

import json

import pytest

from perfbench.tests import tiny

pytestmark = pytest.mark.gpu


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")


@pytest.mark.parametrize("cell", ["tiny.device", "tiny.spec", "tiny.host"])
def test_kernels_pass_the_check_and_the_control_fails_it(tmp_path, cell):
    _need_card()
    result, out, _ = tiny.run(tmp_path, cell, seconds=1.0, readings=True,
                              device="cuda")
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    readings = json.loads(next(line[len("READINGS "):]
                               for line in out.splitlines()
                               if line.startswith("READINGS ")))
    control = {k: v for k, v in readings.items() if "rows" in k}
    assert control and all(v > 0 for v in control.values())
