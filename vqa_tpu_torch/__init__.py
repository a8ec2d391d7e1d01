"""vqa_tpu_torch — the PyTorch + CUDA port of vqa_tpu for NVIDIA Hopper.

Module names mirror ``vqa_tpu/`` (``vqa_tpu_torch/ops/lstm.py`` is the port
of ``vqa_tpu/ops/lstm.py``, and so on). Every Pallas kernel on the ported
path is a hand-written CUDA kernel under ``csrc/``, built with nvcc at first
use (``ops/_build.py``), with its plain PyTorch version beside it in
``ops/``. The package imports torch and never jax; ``vqa_tpu`` stays the
reference it is tested against. Ported so far: inference of MutanAtt,
MFBCoAtt, MFHCoAtt and CoR (eval step and the HTTP answer service), with
all six Pallas kernels, and evaluation over a dataset (data prep, loader,
eval loop, results and scorer behind ``python -m vqa_tpu_torch.cli.train
-e``); see ROADMAP.md for the rest.
"""
