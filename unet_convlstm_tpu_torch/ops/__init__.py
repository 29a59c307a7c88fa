"""Primitives, blocks, ConvLSTM, normalization and the CUDA kernels."""
