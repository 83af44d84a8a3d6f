"""The faults of ``tools/k6_faults.py``, which set chip_smoke.py's limits
for K6 on the card, still go into the kernels they are meant for: the
tensor-core and the CUDA-core kernels of
``src/repro_torch/csrc/attention.cu`` and the backward's of
``attention_bwd.cu``; each of their edits matches its source exactly
once."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("k6_faults",
                                               ROOT / "tools" / "k6_faults.py")
k6_faults = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(k6_faults)
SOURCE = (ROOT / "src" / "repro_torch" / "csrc" / "attention.cu").read_text()


@pytest.mark.parametrize("name", sorted(k6_faults.FAULTS))
def test_fault_applies_to_the_kernel_source(name):
    faulty = k6_faults.apply_fault(SOURCE, name)
    assert faulty != SOURCE
    for _, new in k6_faults.FAULTS[name]:
        assert new in faulty


def test_a_fault_that_no_longer_matches_raises():
    with pytest.raises(ValueError):
        k6_faults.apply_fault(SOURCE.replace("corr", "c0rr"), "corr_one")


CSRC = ROOT / "src" / "repro_torch" / "csrc"


@pytest.mark.parametrize("name", sorted([*k6_faults.F32_FAULTS,
                                         *k6_faults.BWD_FAULTS]))
def test_f32_and_backward_faults_apply_to_their_source(name):
    file, edits = k6_faults.edits_of(name)
    source = (CSRC / file).read_text()
    faulty = k6_faults.apply_fault(source, name)
    assert faulty != source
    for _, new in edits:
        assert new in faulty
