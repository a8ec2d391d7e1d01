"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper takes its kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor, and counts its kernel launches in
``<wrapper>.launches`` (``lstm_seq`` runs all T steps in one launch):

  gather.gather_rows          csrc/gather.cu        <- vqa_tpu/ops/gather.py
  gather.gather_rows_dequant  csrc/gather.cu        <- the same on int8 rows, with the
                                                       dequant of vqa_tpu/engine/steps.py
  lstm.lstm_seq               csrc/lstm.cu          <- vqa_tpu/ops/lstm.py
  attention.glimpse_head      csrc/glimpse_head.cu  <- vqa_tpu/ops/attention.py
  attention.glimpse_attend    csrc/glimpse_head.cu  <- vqa_tpu/ops/attention.py
  mfb_pool.mfb_pool           csrc/mfb_pool.cu      <- vqa_tpu/ops/mfb_pool.py
  relation.relation_attend    csrc/relation.cu      <- vqa_tpu/ops/relation.py

``gru.gru_seq`` (<- vqa_tpu/ops/gru.py) is plain PyTorch on every device:
the JAX package computes the GRU recurrence outside any Pallas kernel.
"""
