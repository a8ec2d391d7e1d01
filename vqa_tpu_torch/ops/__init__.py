"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper takes its kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor, and counts its kernel launches in
``<wrapper>.launches`` (``lstm_seq`` launches one kernel per time step):

  gather.gather_rows        csrc/gather.cu        <- vqa_tpu/ops/gather.py
  lstm.lstm_seq             csrc/lstm.cu          <- vqa_tpu/ops/lstm.py
  attention.glimpse_head    csrc/glimpse_head.cu  <- vqa_tpu/ops/attention.py
"""
