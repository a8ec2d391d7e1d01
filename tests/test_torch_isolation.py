"""The port stands alone: every vqa_tpu_torch module loads in a fresh
interpreter (subprocess, so sys.modules starts clean) with nothing of jax,
flax or optax, and nothing of the JAX package vqa_tpu, in sys.modules.
chip_smoke.py refuses to run without a CUDA card."""

import importlib
import os
import pkgutil
import subprocess
import sys

import torch

import chip_smoke
import vqa_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(vqa_tpu_torch.__path__, "vqa_tpu_torch.")
    )


def _run(code: str, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *(["-c", code] if code else []), *args],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)


def test_every_port_module_is_listed():
    mods = _port_modules()
    for expected in ("vqa_tpu_torch.ops.lstm", "vqa_tpu_torch.predictor",
                     "vqa_tpu_torch.cli.serve", "vqa_tpu_torch.engine.steps"):
        assert expected in mods


def test_port_imports_no_jax():
    """The port and chip_smoke.py import nothing of jax or of vqa_tpu; the
    original HTTP layer, vqa_tpu.cli.serve, imports no jax either."""
    mods = ["vqa_tpu_torch"] + _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
        "'vqa_tpu'))\n"
        "assert not bad, bad\n"
        "heavy = sorted(m for m in ('yaml', 'h5py') if m in sys.modules)\n"
        "assert not heavy, f'imported at module level: {heavy}'\n"
        "importlib.import_module('vqa_tpu.cli.serve')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = _run("", "chip_smoke.py")
    assert proc.returncode != 0
    assert proc.stdout == ""  # no result line, no partial output
    assert "torch.cuda.is_available() is false" in proc.stderr


def test_chip_smoke_plain_path_swaps_every_kernel_call_site():
    """chip_smoke.py compares the kernel path with a plain path built by
    swapping, module by module, each kernel wrapper a model or step calls:
    none may be left out, or the 'plain' path would launch kernels."""
    wrappers = list(chip_smoke._counters().values())
    mods = [importlib.import_module(m) for m in _port_modules()
            if not m.startswith("vqa_tpu_torch.ops.")]

    def call_sites():
        return {(m.__name__, name) for m in mods for name, v in vars(m).items()
                if any(v is w for w in wrappers)}

    before = call_sites()
    assert {m for m, _ in before} >= {"vqa_tpu_torch.models.mfb", "vqa_tpu_torch.models.cor",
                                      "vqa_tpu_torch.models.fusion"}
    with chip_smoke._plain_ops(torch):
        assert call_sites() == set()
    assert call_sites() == before
