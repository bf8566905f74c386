"""PyTorch/CUDA port of variational_mmt_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch and nothing
of JAX or of variational_mmt_tpu. It covers the nmt, vmmt_f and vmmt_c
model types with GRU or LSTM cells, general, dot or mlp attention, with or
without input feed, and pool5 or conv image features (conv regions pooled
by their mean or by attention): translation (beam search with coverage, n-gram blocking,
replace_unk and the search trace; greedy; ancestral sampling and a sampled
latent from per-sentence streams), online serving (serve/: the dynamic
batcher, HTTP and RPC), training (also sequence-packed) with validation and
checkpoints in the JAX package's layout, the train, translate and serve
command lines (cli/), checkpoint ensembles, bf16/int8 inference, the
quality gate (tools/quality_gate.py) and ``tools/embeddings_to_npy.py``,
the custom-backward ``fused_decoder``, and the host input pipeline: the C++
batcher, packer and BPE segmenter (native/, built by g++ at first use) and
the prefetcher on a CUDA copy stream (data/prefetch.py). Multi-device runs
are not ported. Importing it imports nothing. The six kernels (GRU scan and
its backward, decode step, GRU chain, decoder sequence forward and
backward) are CUDA C++ under csrc/, built at first use (kernels.py).
"""
