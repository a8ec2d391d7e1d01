"""vqa_tpu_torch — the PyTorch + CUDA port of vqa_tpu for NVIDIA Hopper.

Module names mirror ``vqa_tpu/`` (``vqa_tpu_torch/ops/lstm.py`` is the port
of ``vqa_tpu/ops/lstm.py``, and so on). Every Pallas kernel on the ported
path is a hand-written CUDA kernel under ``csrc/``, built with nvcc at first
use (``ops/_build.py``), with its plain PyTorch version beside it in
``ops/``. The package imports torch and never jax; ``vqa_tpu`` stays the
reference it is tested against. Ported so far: inference of all nine archs
(MutanAtt, MLBAtt, ConcatAtt, MFBCoAtt, MFHCoAtt, CoR and the NoAtt
family, with the LSTM, GRU or skip-thoughts question encoder; eval step
and the HTTP answer service), with all six Pallas kernels, evaluation over a
dataset (data prep, loader, eval loop, results and scorer behind ``python -m
vqa_tpu_torch.cli.train -e``), training, checkpoints and resume, export to a
frozen ``torch.export`` program that serves without model code
(``export.py``, ``cli/export.py``, ``cli/serve.py --exported``) and the
attention demo (``cli/visu.py``); see ROADMAP.md for the rest.
"""
