"""bench.py's device handling: peak lookup and refusal off the GPU."""

import pytest

import bench


def test_peak_of_h100():
    assert bench.peak_bf16("NVIDIA H100 80GB HBM3") == 989e12


@pytest.mark.parametrize(
    "kind", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "cpu"]
)
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no bf16 peak"):
        bench.peak_bf16(kind)


def test_main_refuses_cpu(capsys):
    assert bench.main() == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "gpu" in captured.err.lower()
