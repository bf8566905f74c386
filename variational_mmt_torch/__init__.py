"""PyTorch/CUDA port of variational_mmt_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch and nothing
of JAX or of variational_mmt_tpu. It covers the nmt, vmmt_f and vmmt_c
model types: beam-search translation, training (also sequence-packed) with
validation and checkpoints in the JAX package's layout, the train and
translate command lines (cli/) and the quality gate
(tools/quality_gate.py). The six kernels (GRU scan and its
backward, decode step, GRU chain, decoder sequence forward and backward)
are CUDA C++ under csrc/, built at first use (kernels.py).
"""
