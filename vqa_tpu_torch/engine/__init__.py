"""Eval step and eval loop of the port, and its experiment logger (the train
step and loop are not ported yet)."""
