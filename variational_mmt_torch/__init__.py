"""PyTorch/CUDA port of variational_mmt_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch and nothing
of JAX or of variational_mmt_tpu. This slice covers vmmt_c beam-search
translation; the GRU-scan, decode-step and GRU-chain kernels are CUDA C++
under csrc/, built at first use (kernels.py).
"""
