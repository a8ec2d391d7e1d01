"""The plain reference of the benchmark's models, in float32 PyTorch.

It follows the published descriptions (MUTAN, arXiv:1705.06676; Chain of
Reasoning, Wu et al., NeurIPS 2018) at the widths of a configuration file
under ``portbench/configs``, and imports nothing of the program: it builds
its own weights from the seed (``params``), runs its own forward
(``models``: the question encoder of ``encoders/<seq2vec arch>.py``, then
the architecture of ``archs/<arch>.py``) and its own train step with adam
(``train``). With ``fp8`` it
computes every matrix product from operands rounded to float8 (e4m3 with a
per-tensor scale; gradients in e5m2), the precision below the bfloat16 the
configurations state: the control that the comparison must fail.
"""
