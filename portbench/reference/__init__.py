"""The plain reference that decides ``correct``: the models' forward pass,
loss and gradients and AdamW, in plain PyTorch at float32 with TF32 off.
It imports nothing of the program and takes no weights, scales or tables
from it: the benchmark's own seeded weights and inputs, worked out anew.
"""
