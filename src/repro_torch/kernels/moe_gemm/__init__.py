"""Grouped expert GEMM: plain torch version, CUDA kernel wrapper, dispatcher."""
