"""Paged attention: plain torch version, CUDA kernel wrapper, dispatcher."""
