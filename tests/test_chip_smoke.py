"""chip_smoke.py: argument handling, the result line, refusal without a
GPU, and every phase rehearsed at tiny sizes on the CPU backend (the
GPU-marked cases run the compared phases on a card)."""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import pytest

import chip_smoke

TINY = chip_smoke.Sizes(
    bin_limit=512, time_step=64, cli_seconds=1.5, parity_seconds=1.0,
    server_seconds=0.5, stream_k=2, stream_blocks=4, train_t=64,
    train_f=512, train_batch=2, train_steps=5, batch_tracks=8,
    long_seconds=3.0,
)


def test_parser_default_and_four_cards():
    parser = chip_smoke.build_parser()
    assert not parser.parse_args([]).four_cards
    assert parser.parse_args(["--four-cards"]).four_cards


def test_parser_rejects_unknown_argument():
    with pytest.raises(SystemExit):
        chip_smoke.build_parser().parse_args(["--cards", "4"])


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev] * count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }


def test_main_without_gpu_prints_no_result(capsys):
    assert chip_smoke.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no GPU" in captured.err


def test_alone_without_the_package_fails(tmp_path):
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert res.stdout == ""


PHASES = {
    "cli": lambda acc, cpu: chip_smoke.phase_cli(TINY, "cpu"),
    "parity": lambda acc, cpu: chip_smoke.phase_parity(TINY, acc, cpu),
    "conserve": lambda acc, cpu: chip_smoke.phase_conserve(TINY),
    "server": lambda acc, cpu: chip_smoke.phase_server(TINY),
    "streams": lambda acc, cpu: chip_smoke.phase_streams(TINY, acc, cpu),
    "train": lambda acc, cpu: chip_smoke.phase_train(TINY),
    "four_cards": lambda acc, cpu: chip_smoke.phase_four_cards(TINY, jax.devices()[:4]),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_rehearsal_on_cpu(phase, cpu_device):
    values = PHASES[phase](cpu_device, cpu_device)
    json.dumps(values)  # printable as the phase's line


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["parity", "streams"])
def test_phase_on_gpu(phase, gpu_device, cpu_device):
    values = PHASES[phase](gpu_device, cpu_device)
    json.dumps(values)
