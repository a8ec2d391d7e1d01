"""The port's engine: the eval and train steps (``steps``), the optimizer
chain (``optim``), the eval and train loops (``engine``), checkpoints
(``checkpoint``), meters and the experiment logger."""
